"""The 95th percentile of every call of the window, ms (host clock): from
handing over a sweep's host arrays to the call returning with its pose on
the host, a loop step the call ran included."""
import statistics


def p95(values):
    """Linear interpolation between closest ranks (``inclusive``)."""
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def read(rec):
    if len(rec.calls) < 2:
        return None
    return p95([c.ms for c in rec.calls])
