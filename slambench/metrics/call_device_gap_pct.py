"""The share of a call's host time in which the card does none of the
call's own work: 100 x (1 - the device span from before the copy-in to
after the clones / the host ms of the call, ``SlamSystem.process``), mean
over the window's calls without a loop step, untraced."""
from slambench.program_trace import mean_over_calls


def gap_pct(r):
    call_ms = (r.t1_ns - r.t0_ns) / 1e6
    if "call" not in r.device or call_ms <= 0:
        return None
    return 100.0 * (1.0 - r.device["call"] / call_ms)


def read(rec):
    return mean_over_calls(rec, gap_pct)
