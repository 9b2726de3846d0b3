"""The port's host-side native code: ear-clipping triangulation and the
COCO RLE codec.

`csrc/earcut.cc` is the JAX package's `arti3d_earcut` and `csrc/rle.cc` its
`arti3d_rle_encode` / `arti3d_rle_decode`, line for line.  Both are built
with `g++` at first use into one library in `_build/` (its name carries a
digest of the sources and the flags) and loaded with ctypes.  A failed
build raises: there is no fallback to a Python ear-clipper, whose
triangles differ, nor to the numpy RLE codec, which is the C++ codec's
test twin (`utils/rle.py`).
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
_SOURCES = [os.path.join(_ROOT, "csrc", n) for n in ("earcut.cc", "rle.cc")]
_BUILD_DIR = os.path.join(_ROOT, "_build")
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
_U8P, _U32P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The library, built and loaded on the first call."""
    lib = ctypes.CDLL(build())
    lib.arti3d_earcut.restype = ctypes.c_int
    lib.arti3d_earcut.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int)]
    lib.arti3d_rle_encode.restype = ctypes.c_int
    lib.arti3d_rle_encode.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _U32P]
    lib.arti3d_rle_decode.restype = None
    lib.arti3d_rle_decode.argtypes = [_U32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P]
    return lib


def lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libarti3d_native_{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile `csrc/earcut.cc` and `csrc/rle.cc` into one library, once per
    source version; returns the path.  Raises RuntimeError when `g++` is
    missing or fails."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run(["g++", *_FLAGS, "-o", tmp, *_SOURCES], capture_output=True,
                             text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot build {_SOURCES} with g++: {e}") from e
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {_SOURCES} ({out.returncode}):\n{out.stderr}")
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


def rle_encode_counts(mask: np.ndarray) -> np.ndarray:
    """(H, W) mask, nonzero = 1 -> column-major run lengths (int64), the
    first run counting zeros."""
    m = np.ascontiguousarray(mask, np.uint8)
    if m.ndim != 2:
        raise ValueError(f"expected an (H, W) mask, got {m.shape}")
    h, w = m.shape
    counts = np.zeros(h * w + 1, np.uint32)
    n = _lib().arti3d_rle_encode(m.ctypes.data_as(_U8P), h, w,
                                 counts.ctypes.data_as(_U32P))
    return counts[:n].astype(np.int64)


def rle_decode_counts(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Column-major run lengths -> (h, w) uint8 mask."""
    c = np.ascontiguousarray(counts, np.uint32)
    mask = np.zeros((h, w), np.uint8)
    _lib().arti3d_rle_decode(c.ctypes.data_as(_U32P), len(c), h, w,
                             mask.ctypes.data_as(_U8P))
    return mask
