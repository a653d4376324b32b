"""Tracing / metrics: the port of ``rgc_slam_tpu/utils/profiling.py``.

The structured upgrade of the reference's TicToc (``tic_toc.h:7-29``):
  * ``TicToc``        — drop-in stopwatch (host wall clock)
  * ``StageTimer``    — named-stage accumulator with p50/p95/max summaries and
    the reference's over-budget warning (>100 ms per scan); a stage given a
    ``device`` synchronizes it before the clock stops, so the time covers
    the device's work and not only its dispatch
  * ``Metrics``       — step-indexed scalar registry dumpable to JSON lines
  * ``trace``         — ``torch.profiler`` over a block, exported as a Chrome
    trace
  * ``tracer``        — the process's ``Tracer``: one record per call of
    ``SlamSystem.process`` / ``process_chunk`` in a bounded ring, holding
    the call's host spans, the device ms of each stage of its replayed
    graph (``utils.graph.mark``) and its VGICP LM iteration counts

``StageTimer.summary`` and ``Metrics.dump`` write the same JSON as the JAX
module (``timing.json`` and ``metrics.jsonl`` of the CLI).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch


class TicToc:
    """Wall-clock stopwatch (ref include/rgc_slam/tic_toc.h)."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        """Elapsed milliseconds."""
        return (time.perf_counter() - self._t0) * 1000.0


def synchronize(device) -> None:
    """Wait for the work queued on ``device``: ``torch.cuda.synchronize`` on
    a CUDA device, nothing on the CPU (its ops have run when they return)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    def __init__(self, budget_ms: float = 100.0, sync: bool = True):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.budget_ms = budget_ms
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, device: Optional[torch.device] = None):
        """Time the block; with ``device`` (and ``sync``) the device is
        synchronized before the clock stops."""
        t0 = time.perf_counter()
        yield
        if self.sync and device is not None:
            synchronize(device)
        ms = (time.perf_counter() - t0) * 1000.0
        self.samples[name].append(ms)
        if ms > self.budget_ms:
            # the reference warns when odometry exceeds its 100 ms real-time
            # budget (RGC_odometer.cpp:1360-1361)
            print(f"[rgc-slam-tpu] stage '{name}' over budget: {ms:.1f} ms")

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: _stats(xs) for name, xs in self.samples.items()}


def _stats(xs, unit: str = "_ms") -> Dict[str, float]:
    a = np.asarray(xs)
    return {
        "count": int(a.size),
        "mean" + unit: float(a.mean()),
        "p50" + unit: float(np.percentile(a, 50)),
        "p95" + unit: float(np.percentile(a, 95)),
        "max" + unit: float(a.max()),
    }


class Metrics:
    """Step-indexed scalar registry with JSONL dump."""

    def __init__(self):
        self.records: List[dict] = []

    def log(self, step: int, **scalars):
        rec = {"step": step}
        for k, v in scalars.items():
            rec[k] = float(v) if np.isscalar(v) or hasattr(v, "item") else v
        self.records.append(rec)

    def dump(self, path: str):
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    def series(self, key: str) -> np.ndarray:
        return np.asarray([r[key] for r in self.records if key in r])


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA when a card is
    present); writes ``trace.json`` (Chrome trace format) into ``log_dir``
    and yields the profiler (``key_averages()`` for tables)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---- the tracer: spans and counters inside the program ----

SPAN_PREFIX = "rgc_slam:"
RING = 65536          # calls the tracer keeps (~4 hours of one stream at 5 calls/s)


class Span(NamedTuple):
    """A host span of one call, on ``time.perf_counter_ns``: the call's id,
    and the index in the call's ``spans`` of the span enclosing it (-1 for
    the call's root)."""

    call: int
    name: str
    t0_ns: int
    t1_ns: int
    parent: int


class CallRecord:
    """One call of the program (``Tracer.call``), kept once it returns.

    ``spans``: its host spans, the root (``process`` or ``process_chunk``)
    first.  ``stages``: device ms of each stage of the graphs it replayed,
    between consecutive ``utils.graph.mark``s, summed over a chunk's scans.
    ``device``: device ms of the replay's parts, from ``_Graph.read``
    (``graph`` first mark to last, ``copy_in``, ``launch`` from the copies'
    end to the graph's first mark, ``clone``, and ``call`` from before the
    copy-in to after the clones).  ``counters``: the VGICP LM's ``lm_outer``
    and ``lm_inner`` iterations summed over the call's scans,
    ``lm_inner_static``, the inner iterations its static counts run, and
    ``map_lm_evals``, the mapping LM kernel's evaluations.
    ``scans``: the scans the call advanced; ``loop``: whether it ran a loop
    step."""

    __slots__ = ("call", "t0_ns", "t1_ns", "spans", "stages", "device", "counters", "scans",
                 "loop", "pending", "open")

    def __init__(self, call: int):
        self.call = call
        self.t0_ns = self.t1_ns = 0
        self.scans = 1
        self.spans: List[Span] = []
        self.stages: Dict[str, float] = {}
        self.device: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        self.loop = False
        self.pending: List[Callable[["CallRecord"], None]] = []
        self.open: List[int] = []


class _SpanBlock:
    """One host span of the open call; while ``torch.profiler`` runs, also
    a ``record_function`` range ``rgc_slam:<name>``."""

    __slots__ = ("rec", "name", "idx", "rf")

    def __init__(self, rec: CallRecord, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec, self.rf = self.rec, None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self.rf.__enter__()
        self.idx = len(rec.spans)
        parent = rec.open[-1] if rec.open else -1
        rec.open.append(self.idx)
        rec.spans.append(Span(rec.call, self.name, time.perf_counter_ns(), 0, parent))
        return rec

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec.open.pop()
        rec.spans[self.idx] = rec.spans[self.idx]._replace(t1_ns=t1)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _CallBlock:
    def __init__(self, tracer: "Tracer", call: int, name: str):
        self.tracer, self.rec = tracer, CallRecord(call)
        self.root = _SpanBlock(self.rec, name)

    def __enter__(self) -> CallRecord:
        if self.tracer.current is not None:
            raise RuntimeError("a traced call is already open")
        self.tracer.current = self.rec
        return self.root.__enter__()

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        self.root.__exit__(exc_type, exc, tb)
        self.tracer.current = None
        if exc_type is None:
            rec.t0_ns, rec.t1_ns = rec.spans[0].t0_ns, rec.spans[0].t1_ns
            for read in rec.pending:
                read(rec)
            rec.pending = rec.open = None
            self.tracer.records.append(rec)
        return False


_NOTHING = contextlib.nullcontext()


def _epoch_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a
    few brackets of the wall clock's read (a preemption between the two
    reads would shift every span put on the profiler's clock)."""
    brackets = []
    for _ in range(5):
        t0 = time.perf_counter_ns()
        wall = time.time_ns()
        t1 = time.perf_counter_ns()
        brackets.append((t1 - t0, wall - (t0 + t1) // 2))
    return min(brackets)[1]


class Tracer:
    """The process's record of the program's calls (``profiling.tracer``).

    ``call(id)`` opens a call (its root span); ``span(name)`` times a
    block of the open call and is a no-op when none is open; ``defer(fn)``
    has ``fn(record)`` run when the call returns, after its pose read has
    waited for the device (``utils.graph`` reads its events so).  The last
    ``ring`` calls are kept in ``records``.  Spans are on
    ``time.perf_counter_ns``; ``epoch_offset_ns`` added to one puts it on
    the Unix-epoch clock of ``torch.profiler``'s events."""

    def __init__(self, ring: int = RING):
        self.records: deque = deque(maxlen=ring)
        self.epoch_offset_ns = _epoch_offset_ns()
        self.current: Optional[CallRecord] = None

    def call(self, call: int, name: str = "process") -> _CallBlock:
        return _CallBlock(self, call, name)

    def span(self, name: str):
        rec = self.current
        return _NOTHING if rec is None else _SpanBlock(rec, name)

    def defer(self, read: Callable[[CallRecord], None]) -> None:
        if self.current is not None:
            self.current.pending.append(read)

    def summary(self, since_ns: int = 0) -> Dict[str, Dict[str, float]]:
        """``StageTimer.summary``'s JSON over the calls that began at or
        after ``since_ns``: each span's host ms a call (a chunk's spans of
        one name summed) under its name, each stage's and replay part's
        device ms under ``device.<name>``, and each counter a call (no
        ``_ms`` on its statistics' keys) under ``counter.<name>``."""
        per: Dict[str, List[float]] = defaultdict(list)
        counted: Dict[str, List[int]] = defaultdict(list)
        for rec in self.records:
            if rec.t0_ns < since_ns:
                continue
            host: Dict[str, float] = defaultdict(float)
            for s in rec.spans:
                host[s.name] += (s.t1_ns - s.t0_ns) / 1e6
            for name, ms in host.items():
                per[name].append(ms)
            for table in (rec.stages, rec.device):
                for name, ms in table.items():
                    per["device." + name].append(ms)
            for name, n in rec.counters.items():
                counted["counter." + name].append(n)
        out = {name: _stats(xs) for name, xs in per.items()}
        out.update((name, _stats(xs, unit="")) for name, xs in counted.items())
        return out


tracer = Tracer()
