"""The metric readers on a canned trace and canned spans, with known
answers."""
import statistics

import pytest

from slambench import run
from slambench.metrics import (device_idle_pct, knn_roofline_pct, loop_step_ms,
                               replay_device_ms, scan_ms_p95, scans_per_s, setup_s)
from slambench.record import Call, RunRecord, Span, Spans, Trace, idle_gaps, union_ns

MS = 1_000_000


def _trace():
    # three calls of 10 ms; the third ran a loop step.  Device work: call 1
    # busy 0-4 and 3-6 ms (6 ms, two overlapping), call 2 busy 11-13 ms and
    # a knn kernel 13-14 ms; call 3 busy 21-29 ms
    ops = [("gemm", 0, 4 * MS), ("add", 3 * MS, 6 * MS), ("knn_chunk_kernel<5>", 1 * MS, 2 * MS),
           ("mul", 11 * MS, 13 * MS), ("knn_merge_kernel", 13 * MS, 14 * MS),
           ("loop_icp", 21 * MS, 29 * MS)]
    spans = [("call", 0, 10 * MS), ("replay", 0, 2 * MS), ("copy_in", 6 * MS, 9 * MS),
             ("call", 10 * MS, 20 * MS), ("call", 20 * MS, 30 * MS),
             ("loop_step", 21 * MS, 30 * MS)]
    calls = [(0, 10 * MS, False), (10 * MS, 20 * MS, False), (20 * MS, 30 * MS, True)]
    return Trace(ops=ops, spans=spans, t0_ns=0, t1_ns=30 * MS, calls=calls)


def _record(**kw):
    calls = [Call(i * 100 * MS, i * 100 * MS + (50 + i) * MS, 2, i % 10 == 9)
             for i in range(40)]
    base = dict(workload="w", calls=calls, window_s=4.0, setup_s=12.5, spans=Spans(),
                trace=_trace(), knn_searches=[(1, 512, 8192, 5), (2, 2048, 32768, 5)])
    base.update(kw)
    return RunRecord(**base)


def test_union_and_gaps():
    assert union_ns([(0, 4), (3, 6), (10, 12)], 0, 11) == 7
    gaps = idle_gaps(_trace())
    assert gaps == [(6 * MS, 11 * MS), (14 * MS, 21 * MS), (29 * MS, 30 * MS)]


def test_device_idle_pct():
    # busy 6 + 3 + 8 = 17 of 30 ms
    assert device_idle_pct.read(_record()) == pytest.approx(100 * 13 / 30)
    assert device_idle_pct.read(_record(trace=None)) is None


def test_replay_device_ms():
    # calls without a loop step: 6 ms and 3 ms of device work
    assert replay_device_ms.read(_record()) == pytest.approx(4.5)


def test_knn_roofline_operation_count():
    least = knn_roofline_pct.least_seconds(1, 512, 8192, 5)
    assert least == pytest.approx(8 * 512 * 8192 / 67e12)      # operations-bound
    # a memory-bound search: 1 query over many points
    assert knn_roofline_pct.least_seconds(1, 1, 10**6, 1) == pytest.approx(
        (12 + 13e6 + 8) / 3.35e12)
    step = knn_roofline_pct.step_least_seconds(_record().knn_searches)
    assert step == pytest.approx(8 * (512 * 8192 + 2 * 2048 * 32768) / 67e12)
    # two counted calls, 2 ms of knn kernels inside them
    assert knn_roofline_pct.read(_record()) == pytest.approx(100 * 2 * step / 2e-3)


def test_end_to_end_readers():
    rec = _record()
    assert scans_per_s.read(rec) == pytest.approx(80 / 4.0)
    ms = [50.0 + i for i in range(40)]
    assert scan_ms_p95.read(rec) == pytest.approx(statistics.quantiles(ms, n=100,
                                                                       method="inclusive")[94])
    # over every call, the loop-step calls included: rank 0.95 * 39 = 37.05
    assert scan_ms_p95.read(rec) == pytest.approx(87.05)
    assert setup_s.read(rec) == 12.5


def test_loop_step_ms_reads_the_window_only():
    spans = Spans()
    spans.spans = [Span("loop_step", -5 * MS, -1 * MS), Span("loop_step", 950 * MS, 952 * MS),
                   Span("loop_step", 1950 * MS, 1956 * MS), Span("replay", 0, 1)]
    assert loop_step_ms.read(_record(spans=spans)) == pytest.approx(4.0)
    assert loop_step_ms.read(_record(spans=Spans())) is None


def test_breakdown_labels_gaps_by_open_span():
    bd = run.breakdown(_trace())
    assert bd["device_ops"][0] == ["loop_icp", 0.008]
    # the innermost span open at a gap's middle: the latest to start, then
    # the first to end
    assert bd["idle_gaps"] == [["call", 0.007], ["copy_in", 0.005], ["loop_step", 0.001]]
