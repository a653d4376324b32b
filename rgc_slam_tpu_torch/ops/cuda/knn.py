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
``launches`` counts the calls that launched the kernel (two or three
launches each, whatever B), and ``launches_by_shape`` the same calls by (B,
queries, points, k); nothing else changes them but ``reset_counts``.  A
call made while a CUDA graph is being captured launches nothing: it is
recorded into the graph, and must be made inside ``capture_counts()``,
which collects the calls the graph holds (elsewhere it raises).  A replay
of the graph launches those kernels with no call here: ``utils.graph``
adds the calls a replayed graph holds to ``replayed`` (by shape, as the
capture recorded them), and what a replay ran is read from the device's own
trace (``torch.profiler``; ``chip_smoke.py`` phases 6, 11 and 12).
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from collections import Counter
from typing import NamedTuple, Optional

import torch

from . import BUILD_DIR, CSRC, build_library, register_counts

SOURCE = os.path.join(CSRC, "knn.cu")
LIBRARY = os.path.join(BUILD_DIR, "libknn.so")
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
replayed: Counter = Counter()               # (B, Q, N, k) -> calls replayed in graphs
_captured: Optional[Counter] = None        # the calls recorded into a graph being captured
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
    """Set ``launches``, ``launches_by_shape`` and ``replayed`` to zero."""
    global launches
    launches = 0
    launches_by_shape.clear()
    replayed.clear()


@contextlib.contextmanager
def capture_counts():
    """Around a CUDA graph's capture: yields a Counter of the calls (by (B,
    queries, points, k)) recorded into the graph, which ``launches`` does
    not count.  A call made while capturing outside this block raises."""
    global _captured
    outer, _captured = _captured, Counter()
    try:
        yield _captured
    finally:
        _captured = outer


register_counts("knn", capture_counts, replayed.update)


def build(verbose: bool = False) -> str:
    """Compile ``csrc/knn.cu`` unless the library is newer than the source.
    Returns the library path; ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report (registers, shared memory, spills)."""
    return build_library(SOURCE, LIBRARY, verbose)


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
    capturing = torch.cuda.is_current_stream_capturing()
    if capturing and _captured is None:
        raise RuntimeError("knn kernel: a call recorded into a CUDA graph outside "
                           "capture_counts(); its replays would launch uncounted kernels")
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
        if capturing:
            _captured[(lanes, nq, n, k)] += 1
        else:
            launches += 1
            launches_by_shape[(lanes, nq, n, k)] += 1
    return (out_d[0], out_i[0]) if single else (out_d, out_i)
