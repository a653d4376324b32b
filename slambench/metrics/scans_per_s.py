"""Scans whose pose reached the host during the window, across all robots,
over the window's seconds (host clock)."""


def read(rec):
    return sum(c.scans for c in rec.calls) / rec.window_s
