"""Wrapper of the Hopper kNN kernel (``csrc/knn.cu``).

Replaces the TPU kernel ``rgc_slam_tpu/ops/pallas/knn_kernel.py::knn_pallas``.
The kernel is compute-bound on FMAs and insertion compares: one thread per
query keeps a sorted top-k in registers while the block streams the points
through shared memory, so the [Q, N] distance matrix that the plain
version writes and sorts (256 MB per call at the mapping association's
2048 x 32768 surf search) never leaves registers.  Thread-per-query leaves
most SMs idle at Q=512; splitting N across blocks is later work.

The library is built with ``nvcc`` from the repository's source at first
use (route (b): a plain C entry point loaded with ctypes), into
``rgc_slam_tpu_torch/_build/``, and rebuilt when the source is newer.
``launches`` counts kernel launches; nothing else changes it.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "knn.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libknn.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
MAX_K = 24          # the TPU kernel's gate (knn_kernel.py:156)

launches = 0
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kNN kernel is built on a machine "
                       "with the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(verbose: bool = False) -> str:
    """Compile ``csrc/knn.cu`` unless the library is newer than the source.
    Returns the library path; ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report (registers, shared memory, spills)."""
    if (not verbose and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), SOURCE, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.rgc_knn_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
            _lib = lib
    return _lib


def knn(queries: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor, k: int):
    """Launch the kernel: (sq_dists [Q, k] float32, indices [Q, k] int32)."""
    global launches
    dev = queries.device
    if dev.type != "cuda" or points.device != dev or points_mask.device != dev:
        raise ValueError("knn kernel: all tensors must be on one CUDA device")
    if queries.dtype != torch.float32 or points.dtype != torch.float32:
        raise TypeError("knn kernel: queries and points must be float32")
    if points_mask.dtype != torch.bool:
        raise TypeError("knn kernel: points_mask must be bool")
    if queries.ndim != 2 or queries.shape[1] != 3 or points.ndim != 2 or points.shape[1] != 3:
        raise ValueError("knn kernel: queries [Q,3] and points [N,3] expected")
    nq, n = queries.shape[0], points.shape[0]
    if points_mask.shape != (n,):
        raise ValueError("knn kernel: points_mask must be [N]")
    if not 1 <= k <= MAX_K or k > n:
        raise ValueError(f"knn kernel: need 1 <= k <= min({MAX_K}, N), got k={k}, N={n}")
    if not (queries.is_contiguous() and points.is_contiguous() and points_mask.is_contiguous()):
        raise ValueError("knn kernel: inputs must be contiguous")
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_i
    center = queries.mean(0)
    lib = _get_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rgc_knn_launch(queries.data_ptr(), points.data_ptr(), points_mask.data_ptr(),
                                 center.data_ptr(), nq, n, k, out_d.data_ptr(),
                                 out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn kernel launch failed: cudaError {err}")
    launches += 1
    return out_d, out_i
