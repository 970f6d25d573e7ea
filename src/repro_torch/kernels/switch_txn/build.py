"""Build ``csrc/switch_txn.cu`` into a shared library and load it.

The library has a plain C interface (loaded with ``ctypes``), so ``nvcc``
compiles it in seconds; nothing includes PyTorch's headers.  It is built at
first use into ``src/repro_torch/kernels/_build/`` (git-ignored), under a
name keyed by the source's hash, so an edited source never loads a stale
library.  There is no fallback: a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "switch_txn.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of this process's build, if it built


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the switch_txn kernels are "
                           "compiled on a machine with the CUDA toolkit")
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.switch_txn_launch.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, ci,
                                      vp]
    lib.switch_txn_launch.restype = ci
    lib.result_gather_launch.argtypes = [vp, ci, vp, vp, ci, vp]
    lib.result_gather_launch.restype = ci
    lib.scan_prune_scratch_len.argtypes = [ci]
    lib.scan_prune_scratch_len.restype = ci
    lib.scan_prune_launch.argtypes = [vp, ci, ci, ci, ci, vp, vp, vp, vp,
                                      ci, vp]
    lib.scan_prune_launch.restype = ci
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on the first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(SOURCE.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"libswitch_txn_{digest[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
            build_seconds = time.perf_counter() - t0
        _lib = _bind(ctypes.CDLL(str(so)))
        return _lib
