"""Build and bind the hand-written CUDA kernels of `csrc/`.

Each source is compiled by `nvcc` into a shared library with a plain C
interface under `_build/` (once per source version: the library's name
carries a digest of the source, every header it includes and the flags)
and loaded with ctypes.  The first kernel a process needs builds every
missing library, one `nvcc` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, List, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]

# kernel name (the C function) -> source
SOURCES = {"roi_align_fwd": "roi_align_fwd.cu", "roi_align_adj": "roi_align_adj.cu",
           "nms": "nms.cu"}
_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _source_files(src: str) -> List[str]:
    """A source and every file of `csrc/` it includes, directly or not."""
    files, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        with open(path) as f:
            todo += [os.path.join(os.path.dirname(path), m)
                     for m in re.findall(r'^#include "([^"]+)"', f.read(), re.M)]
    return files


def _lib_path(name: str) -> Tuple[str, str]:
    """(source, shared library) of one kernel."""
    src = os.path.join(_CSRC, SOURCES[name])
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in _source_files(src):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(_BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build_kernels(names: Sequence[str] = tuple(SOURCES),
                  verbose: bool = False) -> Dict[str, str]:
    """Compile each kernel source into `_build/` (once per source version),
    one `nvcc` per source, all started together.  Returns {name: path}."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        src, path = _lib_path(name)
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *_NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else []) \
            + ["-o", tmp, src]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(f"[build] {name}\n{err}", flush=True)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _lib_path(name)[1] for name in names}


def load(name: str, argtypes: list):
    """The ctypes library of kernel `name`, its C function bound to
    `argtypes` and returning the CUDA error code; builds every missing
    library first."""
    if name not in _libs:
        lib = ctypes.CDLL(build_kernels()[name])
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
