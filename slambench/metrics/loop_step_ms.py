"""Mean host ms of every ``SlamSystem.loop_step`` the window ran (the
driver times the instance's bound method)."""


def read(rec):
    if not rec.calls:
        return None
    lo, hi = rec.calls[0].t0_ns, rec.calls[-1].t1_ns
    ms = [(s.t1_ns - s.t0_ns) / 1e6 for s in rec.spans.named("loop_step")
          if lo <= s.t0_ns and s.t1_ns <= hi]
    return sum(ms) / len(ms) if ms else None
