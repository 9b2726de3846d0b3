"""The port's host-side native code: ear-clipping triangulation.

`csrc/earcut.cc` is the JAX package's `arti3d_earcut`, line for line; it is
built with `g++` at first use into `_build/` (the library's name carries a
digest of the source and the flags) and loaded with ctypes.  A failed
build raises: there is no fallback to a Python ear-clipper, whose triangles
differ.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_ROOT, "csrc", "earcut.cc")
_BUILD_DIR = os.path.join(_ROOT, "_build")
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The library, built and loaded on the first call."""
    lib = ctypes.CDLL(build())
    lib.arti3d_earcut.restype = ctypes.c_int
    lib.arti3d_earcut.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int)]
    return lib


def lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(" ".join(_FLAGS).encode() + f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libearcut_{digest}.so")


def build() -> str:
    """Compile `csrc/earcut.cc` once per source version; returns the path.
    Raises RuntimeError when `g++` is missing or fails."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], capture_output=True,
                             text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot build {_SRC} with g++: {e}") from e
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {_SRC} ({out.returncode}):\n{out.stderr}")
    os.replace(tmp, path)
    return path


def earcut(verts: np.ndarray) -> np.ndarray:
    """(N, 2) simple polygon -> (M, 3) int32 triangle indices."""
    v = np.ascontiguousarray(verts, np.float32)
    if v.ndim != 2 or v.shape[1] != 2:
        raise ValueError(f"expected (N, 2) vertices, got {v.shape}")
    n = v.shape[0]
    if n < 3:
        return np.zeros((0, 3), np.int32)
    out = np.zeros(3 * (n - 2), np.int32)
    m = _lib().arti3d_earcut(v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out[:3 * m].reshape(-1, 3)
