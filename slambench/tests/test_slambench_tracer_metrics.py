"""The readers of the program's own trace (``slambench/program_trace.py``)
on canned tracer records, with known answers: the window's filter, calls
that ran a loop step left out, a chunk's record read a scan at a time, and
None with no records."""
import pytest

from rgc_slam_tpu_torch.utils import profiling
from slambench.metrics import (call_device_gap_pct, features_device_ms, graph_device_ms,
                               launch_host_ms, mapping_device_ms, replay_copy_device_ms,
                               vgicp_iters_used_pct, vgicp_lm_device_ms)
from slambench.record import Call, RunRecord, Spans

MS = 1_000_000
READERS = (features_device_ms, vgicp_lm_device_ms, mapping_device_ms, graph_device_ms,
           replay_copy_device_ms, launch_host_ms, call_device_gap_pct, vgicp_iters_used_pct)


def _call(call, t0_ms, host_ms, scans=1, loop=False, features=2.0, vgicp=90.0, mapping=80.0,
          launch_ms=3.0, inner=10):
    """A call's record: its stages, replay parts and LM counts, ``scans``
    scans' worth summed, as the program records a chunk."""
    r = profiling.CallRecord(call)
    r.t0_ns, r.t1_ns, r.scans, r.loop = t0_ms * MS, (t0_ms + host_ms) * MS, scans, loop
    r.spans = [profiling.Span(call, "process", r.t0_ns, r.t1_ns, -1),
               profiling.Span(call, "launch", r.t0_ns + MS, r.t0_ns + MS + int(launch_ms * MS), 0)]
    stages = {"features": features, "odometry_pre": 10.0, "vgicp_lm": vgicp,
              "odometry_post": 5.0, "downsample": 3.0, "mapping": mapping, "state_copy": 1.0}
    r.stages = {k: v * scans for k, v in stages.items()}
    graph = sum(stages.values()) * scans
    r.device = {"graph": graph, "copy_in": 0.25, "launch": 0.5, "clone": 0.25,
                "call": graph + 1.0}
    r.counters = {"lm_outer": 5 * scans, "lm_inner": inner * scans, "lm_inner_static": 250 * scans}
    return r


def _run(calls):
    """A run whose window spans the host interval of ``calls``."""
    return RunRecord(workload="w", calls=[Call(t0 * MS, t1 * MS, 1) for t0, t1 in calls],
                     window_s=1.0, setup_s=1.0, spans=Spans())


@pytest.fixture()
def tracer(monkeypatch):
    t = profiling.Tracer()
    monkeypatch.setattr(profiling, "tracer", t)
    return t


def test_window_filter_and_loop_calls(tracer):
    """Before the window, after it (the traced sub-window) and a call that
    ran a loop step are left out: only calls 1 and 2 are read."""
    tracer.records.extend([
        _call(0, 0, 250, features=100.0),                  # set-up, before the window
        _call(1, 1000, 200, features=2.0, vgicp=90.0, inner=10, launch_ms=3.0),
        _call(2, 1200, 220, features=4.0, vgicp=94.0, inner=20, launch_ms=5.0),
        _call(3, 1420, 230, loop=True, features=100.0),    # ran a loop step
        _call(4, 5000, 400, features=100.0),               # the traced sub-window
    ])
    rec = _run([(1000, 1200), (1420, 1650)])
    assert features_device_ms.read(rec) == pytest.approx(3.0)
    assert vgicp_lm_device_ms.read(rec) == pytest.approx(92.0)
    assert mapping_device_ms.read(rec) == pytest.approx(80.0)
    assert graph_device_ms.read(rec) == pytest.approx((191.0 + 197.0) / 2)
    assert replay_copy_device_ms.read(rec) == pytest.approx(0.5)
    assert launch_host_ms.read(rec) == pytest.approx(4.0)
    # device 192 of 200 host ms, and 198 of 220
    assert call_device_gap_pct.read(rec) == pytest.approx(
        (100 * (1 - 192 / 200) + 100 * (1 - 198 / 220)) / 2)
    assert vgicp_iters_used_pct.read(rec) == pytest.approx((4.0 + 8.0) / 2)


def test_chunk_record_reads_a_scan(tracer):
    """A chunk of 4 scans in one call: its sums read a scan at a time; the
    share of the call's time and of the LM's work are the call's own."""
    tracer.records.append(_call(7, 100, 800, scans=4, launch_ms=8.0))
    rec = _run([(100, 900)])
    assert features_device_ms.read(rec) == pytest.approx(2.0)
    assert vgicp_lm_device_ms.read(rec) == pytest.approx(90.0)
    assert graph_device_ms.read(rec) == pytest.approx(191.0)
    assert replay_copy_device_ms.read(rec) == pytest.approx(0.125)
    assert launch_host_ms.read(rec) == pytest.approx(2.0)
    assert call_device_gap_pct.read(rec) == pytest.approx(100 * (1 - 765 / 800))
    assert vgicp_iters_used_pct.read(rec) == pytest.approx(4.0)


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_none_without_records(tracer, monkeypatch, reader):
    """No records in the window, no window, or a program without the
    tracer (the parent of the change that added it): None, no error."""
    assert reader.read(_run([(0, 10)])) is None
    assert reader.read(_run([])) is None
    tracer.records.append(_call(1, 0, 200))
    rec = _run([(0, 300)])
    assert reader.read(rec) is not None
    monkeypatch.delattr(profiling, "tracer")
    assert reader.read(rec) is None


def test_untimed_record_reads_none(tracer):
    """The first call (eager, then captured) replays nothing: its record has
    no stage or replay part, and readers of those skip it."""
    r = _call(0, 0, 200)
    r.stages, r.device, r.spans = {}, {}, r.spans[:1]
    tracer.records.append(r)
    rec = _run([(0, 300)])
    for reader in READERS[:-1]:
        assert reader.read(rec) is None
    assert vgicp_iters_used_pct.read(rec) == pytest.approx(4.0)
