"""The kNN kernel's share of its roofline, %: the least time the traced
steps' kNN searches need, over the device time of the ``knn_*`` kernels
inside those steps.

The least time of one search of ``lanes`` x ``queries`` x ``points`` is the
larger of its operations (8 float32 operations per query-point pair) at
the H100's 67 TFLOP/s and its bytes (queries and points read once, each
point's mask byte, distances and indices written once) at 3.35 TB/s.  The
searches come from the configuration's shapes (``RunRecord.knn_searches``),
padded capacities included, so the share reads the same work whatever
program runs the search.  Only calls that ran no loop step count.
"""
from slambench.record import PEAK_F32_FLOPS, PEAK_HBM_BYTES
from slambench.metrics.replay_device_ms import step_calls


def least_seconds(lanes: int, queries: int, points: int, k: int) -> float:
    ops = 8.0 * lanes * queries * points
    nbytes = lanes * (12.0 * queries + 13.0 * points + 8.0 * queries * k)
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def step_least_seconds(searches) -> float:
    return sum(least_seconds(*s) for s in searches)


def read(rec):
    t = rec.trace
    if t is None or not rec.knn_searches:
        return None
    calls = step_calls(t)
    kernel_ns = sum(e - s for name, s, e in t.ops if "knn_" in name
                    and any(c0 <= s < c1 for c0, c1 in calls))
    if not calls or kernel_ns <= 0:
        return None
    return 100.0 * len(calls) * step_least_seconds(rec.knn_searches) / (kernel_ns / 1e9)
