"""Build the port's CUDA sources into shared libraries and load them, and
the checks every kernel launcher makes before a launch.

Each library is one ``csrc/*.cu`` file with a plain C interface (loaded
with ``ctypes``), so ``nvcc`` compiles it in seconds; nothing includes
PyTorch's headers.  A library is built at first use into
``src/repro_torch/kernels/_build/`` (git-ignored), under a name keyed by
its source's hash and the flags, so an edited source never loads a stale
library.  Each library has its own lock, so callers on several threads
build several libraries at once.  There is no fallback: a failed build
raises.
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

import torch

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# library name -> (source, {exported C function: argtypes}); every export
# returns an int (a cudaError_t, or a size)
LIBRARIES = {
    "switch_txn": (KERNELS / "switch_txn" / "csrc" / "switch_txn.cu", {
        "switch_txn_launch": [_vp, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _ci,
                              _vp],
        "switch_txn_smem_bytes": [_ci],
        "switch_txn_smem_launch": [_vp, _ci, _ci, _vp, _vp, _vp, _vp, _ci,
                                   _vp, _vp, _vp, _vp, _ci, _vp],
        "result_gather_launch": [_vp, _ci, _vp, _vp, _ci, _vp],
        "scan_prune_scratch_len": [_ci],
        "scan_prune_launch": [_vp, _ci, _vp, _ci, _ci, _ci, _ci, _vp, _vp],
        "scan_prune_large_launch": [_vp, _ci, _vp, _ci, _ci, _ci, _ci, _vp,
                                    _vp, _ci, _vp],
    }),
    "switch_engine": (KERNELS / "switch_engine" / "csrc" /
                      "switch_engine.cu", {
        "switch_walk_smem_bytes": [_ci],
        "switch_walk_smem_launch": [_ci, _vp, _ci, _ci, _ci, _vp, _vp, _vp,
                                    _vp, _ci, _vp, _vp, _vp, _vp, _ci, _vp,
                                    _vp],
        "switch_walk_scratch_words": [_ci],
        "switch_walk_prep_launch": [_ci, _vp, _ci, _ci, _ci, _vp, _vp, _vp,
                                    _vp, _ci, _vp, _vp, _vp, _vp, _vp, _vp],
        "switch_walk_launch": [_ci, _vp, _ci, _ci, _ci, _vp, _vp, _vp, _vp,
                               _vp, _vp, _vp, _vp, _vp],
    }),
    "moe_route": (KERNELS / "moe_route" / "csrc" / "moe_route.cu", {
        "moe_route_launch": [_vp, _ci, _vp, _vp],
        "moe_plan_launch": [_vp, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp,
                            _vp],
        "moe_plan_streams_launch": [_vp, _ci, _ci, _ci, _ci, _ci, _vp, _vp,
                                    _vp, _vp, _vp],
    }),
}

_locks = {name: threading.Lock() for name in LIBRARIES}
_libs = {}
build_seconds = {}      # name -> wall time of this process's nvcc, if it built
ptxas_log = {}          # name -> what ptxas -v printed, if this process built


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are compiled "
                           "on a machine with the CUDA toolkit")
    return path


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of ``LIBRARIES``), compiled on
    the first call."""
    with _locks[name]:
        if name in _libs:
            return _libs[name]
        source, exports = LIBRARIES[name]
        digest = hashlib.sha256(source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name} "
                                   f"({proc.returncode}):\n{proc.stdout}\n"
                                   f"{proc.stderr}")
            os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
            ptxas_log[name] = proc.stderr
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in exports.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _ci
        _libs[name] = lib
        return lib


def raw_stream():
    """torch's getter of a device's current CUDA stream as a plain int
    (``cudaStream_t``), which builds no ``torch.cuda.Stream``: call it with
    the device index.  Only CUDA builds of torch have it, so a launcher
    looks it up when it first launches."""
    return torch._C._cuda_getCurrentRawStream


# ------------------------------------------------------- launch checks --

def check_int32(name: str, t, n=None):
    """``t`` must be a contiguous 1-D int32 tensor (of length ``n``)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D tensor, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name}: expected length {n}, got {t.shape[0]}")


def same_device(*ts):
    """The one device, cpu or cuda, that all of ``ts`` lie on."""
    dev = ts[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return dev


def raise_on(err: int, name: str):
    """Raise if a launcher's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
