"""Device-busy ms per replayed step: the union of the device operations
that start inside a traced call which ran no loop step, averaged over
those calls."""
from slambench.record import union_ns


def step_calls(trace):
    return [(s, e) for s, e, loop in trace.calls if not loop]


def read(rec):
    t = rec.trace
    if t is None:
        return None
    calls = step_calls(t)
    if not calls:
        return None
    busy = [union_ns([(s, e) for _, s, e in t.ops if c0 <= s < c1], c0, 1 << 62)
            for c0, c1 in calls]
    return sum(busy) / len(busy) / 1e6
