"""What one run records, for the metric readers: the timed calls, the host
spans around the program's layers, the traced sub-window's device
operations, and the constants the readers divide by.

Host spans are taken with ``time.perf_counter_ns`` around the benchmark's
own calls into the program (``Spans.span``); inside the traced sub-window
each span is also a ``torch.profiler.record_function`` range, so the
trace places it on the device operations' clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Tuple

# NVIDIA's data sheet, H100 SXM, dense: float32 outside the tensor cores
# and HBM3 bandwidth (at the full 700 W power limit)
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
SPAN_PREFIX = "slambench:"


@dataclasses.dataclass
class Call:
    """One timed call of the window: host ns at its start and its end, the
    scans whose poses it brought to the host, and whether it ran a loop
    step."""

    t0_ns: int
    t1_ns: int
    scans: int
    loop_step: bool = False
    cpu_ns: int = 0          # the process's CPU time during the call

    @property
    def ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


@dataclasses.dataclass
class Span:
    name: str
    t0_ns: int
    t1_ns: int


class Spans:
    """Host spans by name.  ``span`` times a block; while ``traced`` is set
    it also marks the block for the profiler as ``slambench:<name>``."""

    def __init__(self):
        self.spans: List[Span] = []
        self.traced = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            import torch

            rf = torch.profiler.record_function(SPAN_PREFIX + name)
        with rf:
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                self.spans.append(Span(name, t0, time.perf_counter_ns()))

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


@dataclasses.dataclass
class Trace:
    """The traced sub-window on one clock (ns): device operations (name,
    start, end), the benchmark's host spans (name, start, end) and the
    window's bounds.  ``calls`` are the spans of whole calls, in order,
    with whether each ran a loop step."""

    ops: List[Tuple[str, int, int]]
    spans: List[Tuple[str, int, int]]
    t0_ns: int
    t1_ns: int
    calls: List[Tuple[int, int, bool]]

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(trace: Trace) -> List[Tuple[int, int]]:
    """The traced window's stretches with no device operation running."""
    gaps, cursor = [], trace.t0_ns
    for s, e in sorted((s, e) for _, s, e in trace.ops):
        if s > cursor:
            gaps.append((cursor, min(s, trace.t1_ns)))
        cursor = max(cursor, e)
        if cursor >= trace.t1_ns:
            break
    if cursor < trace.t1_ns:
        gaps.append((cursor, trace.t1_ns))
    return [(s, e) for s, e in gaps if e > s]


@dataclasses.dataclass
class RunRecord:
    """Everything a metric reader may read (``slambench/metrics/*.py``)."""

    workload: str
    calls: List[Call]
    window_s: float
    setup_s: float
    spans: Spans
    trace: Optional[Trace] = None
    # the kNN searches one step (one call of the compiled step) makes:
    # [(lanes, queries, points, k)], from the configuration's shapes
    knn_searches: List[Tuple[int, int, int, int]] = dataclasses.field(default_factory=list)
