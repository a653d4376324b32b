"""The program's own trace, as the per-layer metrics that read it see it.

The program keeps a record of each of its calls in
``rgc_slam_tpu_torch.utils.profiling.tracer`` (host spans, the device ms of
each stage of the replayed graph, the VGICP LM's iteration counts).  A
reader takes the records of the window's calls that ran no loop step: those
whose host interval lies inside the window's, the filter ``loop_step_ms``
uses, so the traced sub-window after it never enters.  A program without
the tracer, or with nothing recorded, gives no records, and the reader
returns None.
"""
from __future__ import annotations

from typing import Callable, List, Optional


def records(rec) -> list:
    """The program's records of the window's calls without a loop step."""
    if not rec.calls:
        return []
    from rgc_slam_tpu_torch.utils import profiling

    tracer = getattr(profiling, "tracer", None)
    if tracer is None:
        return []
    lo, hi = rec.calls[0].t0_ns, rec.calls[-1].t1_ns
    return [r for r in tracer.records if lo <= r.t0_ns and r.t1_ns <= hi and not r.loop]


def mean_over_calls(rec, value: Callable) -> Optional[float]:
    """Mean of ``value(record)`` over the window's records without a loop
    step, those where it is not None; None if there are none."""
    values: List[float] = [v for v in map(value, records(rec)) if v is not None]
    return sum(values) / len(values) if values else None


def stage_ms(name: str) -> Callable:
    """A record's device ms of the stage ``name`` a scan (a chunk's sum over
    its scans)."""
    def value(r):
        ms = r.stages.get(name)
        return None if ms is None else ms / r.scans
    return value


def device_ms(*names: str) -> Callable:
    """A record's device ms of the replay's parts ``names`` together, a
    scan."""
    def value(r):
        if not all(n in r.device for n in names):
            return None
        return sum(r.device[n] for n in names) / r.scans
    return value


def span_ms(name: str) -> Callable:
    """A record's host ms in the spans named ``name``, a scan."""
    def value(r):
        ms = [(s.t1_ns - s.t0_ns) / 1e6 for s in r.spans if s.name == name]
        return sum(ms) / r.scans if ms else None
    return value
