"""Wrapper of the Hopper kNN kernel (``csrc/knn.cu``).

Replaces the TPU kernel ``rgc_slam_tpu/ops/pallas/knn_kernel.py::knn_pallas``.
The kernel is compute-bound on the 8 float32 operations of each
(query, point) pair.  A first small kernel sums each search's query mean
(the centre).  The point axis is split into S contiguous chunks across
blocks, so that the card's SMs all have work; each thread keeps the top-k
of its query over its block's chunk in registers, and a last kernel merges
the S partial lists.  A batch of B independent searches of one shape (a
fleet's robots) rides one call, on the grid's third axis.
``split_plan`` chooses the block size and S from the shapes, B and the
card's SM count.

The library is built with ``nvcc`` from the repository's source at first
use (a plain C entry point loaded with ctypes), into
``rgc_slam_tpu_torch/_build/``, and rebuilt when the source is newer.
``launches`` counts the calls that reached the kernel (two or three
launches each, whatever B), and ``launches_by_shape`` the same calls by (B,
queries, points, k); nothing else changes them but ``reset_counts``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from typing import NamedTuple, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "knn.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libknn.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
MAX_K = 24          # the TPU kernel's gate (knn_kernel.py:156)
MAX_CHUNKS = 65535  # the grid's y extent
MAX_LANES = 65535   # the grid's z extent

# split_plan's targets: warps in flight per SM, blocks per SM, and the
# shortest chunk it cuts (shorter chunks spend a larger share of their scan
# refilling the top-k, and the merge reads more lists)
WARPS_PER_SM = 16
BLOCKS_PER_SM = 2
MIN_CHUNK = 128

launches = 0
launches_by_shape: Counter = Counter()      # (B, Q, N, k) -> calls
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class SplitPlan(NamedTuple):
    threads: int              # threads (queries) per block: 32, 64 or 128
    chunks: int               # S: point chunks, one block column each
    chunk: int                # points per chunk; the last chunk is ragged

    def blocks(self, nq: int, lanes: int = 1) -> int:
        return lanes * -(-nq // self.threads) * self.chunks


def split_plan(nq: int, n: int, k: int, num_sms: int, chunks: Optional[int] = None,
               lanes: int = 1) -> SplitPlan:
    """Block size and point split for ``lanes`` searches of ``nq`` queries
    over ``n`` points each.

    S is chosen so that the query warps of all lanes times the chunks give
    ``WARPS_PER_SM`` warps on every SM, with no chunk shorter than
    ``MIN_CHUNK`` points (S = 1 below twice that, and wherever the lanes'
    query warps alone fill the card).  The block size is the first of 128,
    64 and 32 threads that gives ``BLOCKS_PER_SM`` blocks per SM, else 32.
    ``chunks`` forces S; it must cut ``n`` into that many non-empty chunks of
    ``ceil(n / chunks)`` points, else ``ValueError``.  The plan does not
    change the result."""
    if nq <= 0 or n <= 0 or not 1 <= k <= MAX_K or not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"knn split: need nq > 0, n > 0, 1 <= k <= {MAX_K}, "
                         f"1 <= lanes <= {MAX_LANES}")
    if chunks is None:
        chunks = -(-WARPS_PER_SM * num_sms // (lanes * -(-nq // 32)))
        chunks = max(1, min(chunks, n // MIN_CHUNK, MAX_CHUNKS))
        chunks = -(-n // -(-n // chunks))        # no empty chunk
    elif not 1 <= chunks <= min(n, MAX_CHUNKS) or (chunks - 1) * -(-n // chunks) >= n:
        raise ValueError(f"knn split: {chunks} chunks cannot cut {n} points into non-empty "
                         f"chunks of ceil(n / chunks) points")
    for threads in (128, 64, 32):
        plan = SplitPlan(threads, chunks, -(-n // chunks))
        if plan.blocks(nq, lanes) >= BLOCKS_PER_SM * num_sms:
            break
    return plan


def reset_counts():
    """Set ``launches`` and ``launches_by_shape`` to zero."""
    global launches
    launches = 0
    launches_by_shape.clear()


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
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_longlong] * 3
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5)
            _lib = lib
    return _lib


def _lane_stride(x: torch.Tensor, what: str) -> int:
    """Elements from one lane of ``x`` [B, ...] to the next: 0 where every
    lane is the same tensor (an ``expand``), else the lane's extent; each
    lane itself must be contiguous."""
    if not x[0].is_contiguous():
        raise ValueError(f"knn kernel: each lane of {what} must be contiguous")
    extent = x[0].numel()
    if x.shape[0] == 1 or x.stride(0) == extent:
        return extent
    if x.stride(0) == 0:
        return 0
    raise ValueError(f"knn kernel: lanes of {what} must be contiguous or shared")


def knn(queries: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor, k: int,
        chunks: Optional[int] = None):
    """Launch the kernel once: (sq_dists [B, Q, k] float32, indices [B, Q, k]
    int32) for queries [B, Q, 3], points [B, N, 3] and points_mask [B, N];
    without the leading B axis on all three, one search and results without
    it.  A lane of points or mask may be shared (stride 0, from
    ``expand``).  ``chunks`` forces the number of point chunks S (the result
    does not depend on it); by default ``split_plan`` chooses it."""
    global launches
    dev = queries.device
    if dev.type != "cuda" or points.device != dev or points_mask.device != dev:
        raise ValueError("knn kernel: all tensors must be on one CUDA device")
    if queries.dtype != torch.float32 or points.dtype != torch.float32:
        raise TypeError("knn kernel: queries and points must be float32")
    if points_mask.dtype != torch.bool:
        raise TypeError("knn kernel: points_mask must be bool")
    single = queries.ndim == 2
    if single:
        queries, points, points_mask = queries[None], points[None], points_mask[None]
    if queries.ndim != 3 or queries.shape[2] != 3 or points.ndim != 3 or points.shape[2] != 3:
        raise ValueError("knn kernel: queries [B,Q,3] and points [B,N,3] expected")
    lanes, nq, n = queries.shape[0], queries.shape[1], points.shape[1]
    if points.shape[0] != lanes or points_mask.shape != (lanes, n):
        raise ValueError("knn kernel: points [B,N,3] and points_mask [B,N] must match queries' B")
    if not 1 <= k <= MAX_K or k > n:
        raise ValueError(f"knn kernel: need 1 <= k <= min({MAX_K}, N), got k={k}, N={n}")
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"knn kernel: need 1 <= B <= {MAX_LANES}, got {lanes}")
    strides = [_lane_stride(x, name) for x, name in
               ((queries, "queries"), (points, "points"), (points_mask, "points_mask"))]
    out_d = torch.empty((lanes, nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((lanes, nq, k), dtype=torch.int32, device=dev)
    if nq > 0:
        plan = split_plan(nq, n, k, torch.cuda.get_device_properties(dev).multi_processor_count,
                          chunks, lanes)
        ws_key = ws_idx = None
        if plan.chunks > 1:
            ws_key = torch.empty((lanes, plan.chunks, nq, k), dtype=torch.int32, device=dev)
            ws_idx = torch.empty((lanes, plan.chunks, nq, k), dtype=torch.int32, device=dev)
        center = torch.empty((lanes, 3), dtype=torch.float32, device=dev)   # the kernel's
        lib = _get_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.rgc_knn_launch(
                queries.data_ptr(), points.data_ptr(), points_mask.data_ptr(), center.data_ptr(),
                lanes, *strides, nq, n, k, plan.threads, plan.chunks, plan.chunk,
                None if ws_key is None else ws_key.data_ptr(),
                None if ws_idx is None else ws_idx.data_ptr(), out_d.data_ptr(),
                out_i.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"knn kernel launch failed: cudaError {err}")
        launches += 1
        launches_by_shape[(lanes, nq, n, k)] += 1
    return (out_d[0], out_i[0]) if single else (out_d, out_i)
