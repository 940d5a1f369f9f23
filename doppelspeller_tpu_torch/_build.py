"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface, bound
with ``ctypes``; the ``nvcc`` processes run side by side.  The libraries
live in ``build/torch_kernels/`` at the repository root, each named by a
hash of its source (and the shared headers), so an edited kernel is rebuilt
and an unchanged one is loaded as it is.  The first call of ``lib`` builds
and loads under a lock, so the mesh's worker threads may launch at once;
the wrappers count their launches with ``count``, under another.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# entry point -> (source file, argument types)
_SIGNATURES = {
    "doppel_score_window_select": ("score_window.cu",
                                   [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _P]),
    "doppel_window_best": ("window_lcs.cu", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "doppel_lcs_pairs": ("lcs_pairs.cu", [_P, _L, _P, _I, _P, _L, _P, _I, _P, _I, _I, _I, _P]),
    "doppel_gather_rows": ("gather_rows.cu", [_P, _P, _P, _I, _L, _P]),
    "doppel_score_full": ("score_full.cu",
                          [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P]),
    "doppel_score_sparse_topk": ("score_sparse_topk.cu",
                                 [_P] * 10 + [_I, _I, _I, _L, _I, _I, _I, _I, _P]),
    "doppel_select_rescore": ("fold_rescore.cu", [_P] * 9 + [_I] * 7 + [_P]),
}

_LIB: Optional[SimpleNamespace] = None
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
BUILD_SECONDS: Optional[float] = None
# source file name -> what nvcc and ptxas printed (registers, spills, shared
# memory per kernel) when this process built it
BUILD_LOG: Dict[str, str] = {}


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def library_path(source: str) -> str:
    h = hashlib.sha256()
    for path in [source] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build() -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together; returns {source file name: library path}."""
    global BUILD_SECONDS
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = {os.path.basename(src): library_path(src) for src in sources()}
    todo = {src: out[os.path.basename(src)] for src in sources()
            if not os.path.exists(out[os.path.basename(src)])}
    if not todo:
        return out
    t0 = time.time()
    nvcc = _nvcc()
    procs = []
    for src, lib_path in todo.items():
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        procs.append((src, lib_path, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, lib_path, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{os.path.basename(src)} ({proc.returncode}):\n{err}")
        else:
            BUILD_LOG[os.path.basename(src)] = err
            os.replace(tmp, lib_path)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    BUILD_SECONDS = time.time() - t0
    return out


def lib() -> SimpleNamespace:
    """Every kernel entry point as an attribute (built on first call)."""
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                paths = build()
                handles = {name: ctypes.CDLL(path) for name, path in paths.items()}
                fns = {}
                for name, (source, argtypes) in _SIGNATURES.items():
                    fn = getattr(handles[source], name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name] = fn
                _LIB = SimpleNamespace(**fns)
    return _LIB


def count(fn, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to the launch count ``fn.<attr>`` (several threads launch)."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + n)


def check(rc: int, name: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
