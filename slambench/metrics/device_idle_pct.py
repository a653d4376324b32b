"""Share of the traced sub-window in which no device operation ran, %
(``torch.profiler``'s device activity)."""
from slambench.record import union_ns


def read(rec):
    t = rec.trace
    if t is None or t.t1_ns <= t.t0_ns:
        return None
    busy = union_ns([(s, e) for _, s, e in t.ops], t.t0_ns, t.t1_ns)
    return 100.0 * (1.0 - busy / (t.t1_ns - t.t0_ns))
