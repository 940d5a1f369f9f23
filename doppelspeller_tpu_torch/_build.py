"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, bound with
``ctypes``.  The library lives in ``build/torch_kernels/`` at the repository
root, named by a hash of the sources, so an edited kernel is rebuilt and an
unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "doppel_score_window_select": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   ctypes.c_longlong, _I, _I, _I, _I, _P],
    "doppel_window_best": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libdoppel_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is missing; returns its path."""
    global BUILD_SECONDS
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cu = [p for p in sources() if p.endswith(".cu")]
    t0 = time.time()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.time() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
