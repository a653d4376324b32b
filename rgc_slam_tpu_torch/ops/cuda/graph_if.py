"""Conditional IF nodes in a CUDA graph being captured (``csrc/graph_if.cu``).

``if_node(pred, body)`` records ``body()`` under an IF node of the graph
that the current stream is capturing: every replay runs the body's
operations only where ``pred``, a bool on the card, holds when the replay
reaches the node; elsewhere it skips them.  It reads nothing from the
device on the host, so a step that uses it stays free of host reads.  The
library is built with ``nvcc`` at first use, like ``knn``'s.

The body is captured from a stream of its own, and the tensors it makes
come from a memory pool of its own, shared by the bodies of every graph on
the device and kept for the process (graphs that hold bodies must not be
replayed at the same time; a tensor a body makes is dead when it ends).  A
body hands its results on only by writing into tensors made before it: a
tensor it makes holds nothing where a replay skips it.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from . import BUILD_DIR, CSRC, build_library

SOURCE = os.path.join(CSRC, "graph_if.cu")
LIBRARY = os.path.join(BUILD_DIR, "libgraph_if.so")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_bodies: Dict[int, Tuple[torch.cuda.Stream, tuple]] = {}   # device -> (stream, pool)


def build(verbose: bool = False) -> str:
    """Compile ``csrc/graph_if.cu`` unless the library is newer than it."""
    return build_library(SOURCE, LIBRARY, verbose)


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.rgc_graph_if_begin.restype = ctypes.c_int
            lib.rgc_graph_if_begin.argtypes = [ctypes.c_void_p] * 3
            lib.rgc_graph_if_end.restype = ctypes.c_int
            lib.rgc_graph_if_end.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def _body_stream(dev: torch.device, capturing: torch.cuda.Stream):
    """The stream that captures ``dev``'s bodies (one of PyTorch's pool,
    never the capturing stream) and the memory pool of their tensors."""
    with _lock:
        stream, pool = _bodies.get(dev.index, (None, None))
        if pool is None:
            pool = torch.cuda.graph_pool_handle()
        while stream is None or stream == capturing:
            stream = torch.cuda.Stream(dev)
        _bodies[dev.index] = stream, pool
    return stream, pool


def if_node(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """Capture ``body()`` under an IF node on ``pred`` (a one-element bool
    tensor on the card) into the graph the current stream is capturing."""
    if pred.device.type != "cuda" or pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError("if_node: the predicate must be one bool on a CUDA device")
    dev = pred.device
    lib = _get_lib()
    capturing = torch.cuda.current_stream(dev)
    stream, pool = _body_stream(dev, capturing)
    err = lib.rgc_graph_if_begin(pred.data_ptr(), capturing.cuda_stream, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"if_node: the IF node was not added (cudaError {err}); "
                           f"is the current stream capturing a graph?")
    try:
        with torch.cuda.stream(stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, pool)
            try:
                body()
            finally:
                torch._C._cuda_endAllocateToPool(dev.index, pool)
    finally:
        err = lib.rgc_graph_if_end(stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"if_node: the body's capture failed (cudaError {err})")
