"""The program's own trace: ``utils.profiling.tracer``, the stage marks of
the captured step (``utils.graph.mark``) and the VGICP LM's counts
(``SlamOutput.lm_iters``).

On the CPU: tracing changes no output and no state, bit for bit, and with
it off nothing is recorded; the ring keeps within its bound and every span
carries its call and its parent; a span put on the profiler's clock through
the epoch offset starts with its ``rgc_slam:`` range; ``lm_iters`` counts
what the LM's own trace (``with_trace=True``) counts, for one stream and
under the fleet's vmap.  On the card (marked ``gpu``, skipped without
CUDA): the stages tile the replayed graph's span, and a replay with marks
is bit-equal to one without.

The file imports no jax, so it also runs where only the port's
dependencies are:

    python -m pytest --noconftest -q tests/test_torch_tracing.py
"""
import dataclasses
import json

import pytest
import torch
import torch.utils._pytree as pytree
from torch.profiler import ProfilerActivity, profile

from rgc_slam_tpu_torch import run
from rgc_slam_tpu_torch.config import TEST_CONFIG
from rgc_slam_tpu_torch.io import synthetic
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu_torch.models.slam import SlamState, SlamSystem, slam_step
from rgc_slam_tpu_torch.ops import registration
from rgc_slam_tpu_torch.parallel import fleet
from rgc_slam_tpu_torch.runtime.loader import write_sequence
from rgc_slam_tpu_torch.types import tree_stack
from rgc_slam_tpu_torch.utils import graph, profiling

torch.set_num_threads(1)

CFG = dataclasses.replace(TEST_CONFIG, loop_cadence=2)
NO_LOOPS = dataclasses.replace(TEST_CONFIG, loop_closure_enable=False)
FLEET_CFG = dataclasses.replace(TEST_CONFIG, inline_compaction=False)
STAGES = ["features", "odometry_pre", "vgicp_lm", "odometry_post", "downsample", "mapping"]
N_SCANS = 3
# the VGICP LM's bodies a scan on the masked loop (the CPU's): two a
# static outer slot and one a static inner one
STATIC_BODIES = TEST_CONFIG.vgicp_max_iterations * (2 + TEST_CONFIG.lm_max_inner)


def _seq(seed: int, n_scans: int):
    return synthetic.generate_sequence(n_scans=n_scans + 1, n_azimuth=120, seed=seed,
                                       extent=15.0, radius=6.0, noise=0.004,
                                       closes_loop=False, speed=1.5)


def _inputs(seq, k, cfg, device="cpu"):
    t_imu, acc, gyr = seq["imu"][k]
    return (cloud_from_scan_dict(seq["scans"][k], cfg, device),
            imu_from_interval(t_imu, acc, gyr, cfg.max_imu, device), seq["stamps"][k])


def _run(seq, cfg, trace: bool, device="cpu") -> SlamSystem:
    system = SlamSystem(cfg, device=device, trace=trace)
    for k in range(N_SCANS):
        system.process(*_inputs(seq, k, cfg, device))
    return system


def _assert_same(a: SlamSystem, b: SlamSystem):
    for x, y in zip(pytree.tree_leaves((a.state, a.loop_state)),
                    pytree.tree_leaves((b.state, b.loop_state))):
        assert torch.equal(x, y)
    for (sa, qa, ta), (sb, qb, tb) in zip(a.trajectory + a.odom_trajectory,
                                          b.trajectory + b.odom_trajectory):
        assert sa == sb and (qa == qb).all() and (ta == tb).all()


class _Event:
    """A stand-in for the card's timing event: ``mark`` records it."""

    def record(self):
        pass


@pytest.fixture(scope="module")
def seq():
    return _seq(9, N_SCANS)


@pytest.fixture()
def fresh(monkeypatch):
    """A tracer of this test's own, in place of the process's."""
    tracer = profiling.Tracer()
    monkeypatch.setattr(profiling, "tracer", tracer)
    return tracer


def test_tracing_changes_nothing(seq, fresh):
    """``SlamSystem`` with tracing on and off, loops every 2 scans: the same
    state and trajectories bit for bit; off records nothing, on one record
    a call with its spans, LM counts and loop flag, and its summary holds
    the counts.  ``slam_step`` under
    ``graph.marking`` (a traced capture's marks) gives the same outputs and
    state as without, and passes the stages' marks in order."""
    off = _run(seq, CFG, trace=False)
    assert not fresh.records
    on = _run(seq, CFG, trace=True)
    _assert_same(on, off)
    assert [r.call for r in fresh.records] == list(range(N_SCANS))
    static = CFG.vgicp_max_iterations * CFG.lm_max_inner
    for r in fresh.records:
        names = [s.name for s in r.spans]
        assert names[:2] == ["process", "pose_read"] and r.scans == 1
        assert r.loop == (r.call % 2 == 1) == ("loop_step" in names)
        if r.loop:
            assert names[2:] == ["loop_step", "loop.compact", "loop.search"]
            assert [s.parent for s in r.spans] == [-1, 0, 0, 2, 2]
        assert r.t0_ns == r.spans[0].t0_ns and r.t1_ns == r.spans[0].t1_ns
        assert 1 <= r.counters["lm_outer"] <= r.counters["lm_inner"] <= static
        assert r.counters["lm_inner_static"] == static
        assert r.counters["lm_bodies_run"] == STATIC_BODIES
        assert not r.stages and not r.device            # the CPU replays no graph
    summary = fresh.summary()
    for name in ("lm_outer", "lm_inner", "lm_inner_static", "lm_bodies_run"):
        assert set(summary["counter." + name]) == {"count", "mean", "p50", "p95", "max"}
        assert summary["counter." + name]["count"] == N_SCANS
    assert summary["counter.lm_inner_static"]["max"] == static
    bodies = summary["counter.lm_bodies_run"]
    assert bodies["max"] == bodies["p50"] == STATIC_BODIES

    state_a = state_b = SlamState.init(NO_LOOPS, "cpu")
    for k in range(2):
        cloud, imu, stamp = _inputs(seq, k, NO_LOOPS)
        stamp = torch.tensor(stamp, dtype=torch.float32)
        state_a, out_a = slam_step(state_a, cloud, imu, stamp, NO_LOOPS)
        with graph.marking(_Event) as marks:
            state_b, out_b = slam_step(state_b, cloud, imu, stamp, NO_LOOPS)
        assert [name for name, _ in marks] == STAGES
        for x, y in zip(pytree.tree_leaves((state_a, out_a)), pytree.tree_leaves((state_b, out_b))):
            assert torch.equal(x, y)


def test_ring_bound_spans_and_summary():
    tracer = profiling.Tracer(ring=3)
    with tracer.span("outside"):
        pass
    tracer.defer(lambda rec: pytest.fail("no call is open"))
    for i in range(5):
        with tracer.call(10 + i):
            with tracer.span("a"):
                with tracer.span("b"):
                    pass
            with tracer.span("c"):
                pass
    assert [r.call for r in tracer.records] == [12, 13, 14]
    for r in tracer.records:
        assert [s.name for s in r.spans] == ["process", "a", "b", "c"]
        assert [s.parent for s in r.spans] == [-1, 0, 1, 0]
        assert all(s.call == r.call for s in r.spans)
        for s in r.spans[1:]:
            p = r.spans[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    summary = tracer.summary()
    assert set(summary) == {"process", "a", "b", "c"}
    assert set(summary["a"]) == {"count", "mean_ms", "p50_ms", "p95_ms", "max_ms"}
    assert summary["a"]["count"] == 3
    assert tracer.summary(since_ns=tracer.records[-1].t0_ns)["c"]["count"] == 1
    with pytest.raises(RuntimeError):
        with tracer.call(0):
            with tracer.call(1):
                pass
    assert tracer.current is None


def test_span_on_the_profilers_clock():
    """A warm span's start, moved by the epoch offset, within 0.2 ms of the
    start of its ``rgc_slam:`` range in a CPU ``torch.profiler`` trace; no
    range is entered when no profiler runs."""
    tracer = profiling.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(6):
            with tracer.call(i):
                with tracer.span("probe"):
                    pass
    ranges = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == profiling.SPAN_PREFIX + "probe")
    spans = [r.spans[1].t0_ns + tracer.epoch_offset_ns for r in tracer.records]
    assert len(ranges) == len(spans) == 6
    assert abs(ranges[-1] - spans[-1]) <= 200_000
    assert tracer.records[-1].spans[1].parent == 0


def _physical(t: torch.Tensor) -> torch.Tensor:
    """A tensor made under vmap as its lanes, stacked first (functorch's
    physical tensor); any other tensor as it is."""
    F = torch._C._functorch
    while F.is_batchedtensor(t):
        t = F.get_unwrapped(t).movedim(F.maybe_get_bdim(t), 0)
    return t.clone()


def _traced_lm(monkeypatch):
    """Make ``lm_register`` also count its trace's iterations (outer, and
    rejects plus accepted steps), kept for the test to read."""
    counted = []
    lm_register = registration.lm_register

    def with_trace(*args, **kwargs):
        result, trace = lm_register(*args, with_trace=True, **kwargs)
        steps = trace["n_rejects"].sum(-1) + trace["accepted"].to(torch.int32).sum(-1)
        counted.append(_physical(torch.stack([trace["n_outer"], steps], -1)))
        return result

    monkeypatch.setattr(registration, "lm_register", with_trace)
    return counted


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_lm_iters_count_the_lm_trace(monkeypatch, seed):
    """``lm_iters`` = (outer iterations, rejects + accepted steps) of the
    LM's trace: one stream, and two robots of different worlds under the
    fleet's vmap (one pair a lane)."""
    counted = _traced_lm(monkeypatch)
    seqs = [_seq(seed, 2), _seq(seed + 100, 2)]
    state = SlamState.init(TEST_CONFIG, "cpu")
    states = fleet.fleet_init(FLEET_CFG, 2, "cpu")
    for k in range(2):
        cloud, imu, stamp = _inputs(seqs[0], k, TEST_CONFIG)
        state, out = slam_step(state, cloud, imu, torch.tensor(stamp, dtype=torch.float32),
                               TEST_CONFIG)
        assert out.lm_iters.dtype == torch.int32 and out.lm_iters.shape == (3,)
        assert torch.equal(out.lm_iters[:2], counted[-1])
        assert int(out.lm_iters[2]) == STATIC_BODIES
        lanes = [_inputs(s, k, FLEET_CFG) for s in seqs]
        clouds, imus = tree_stack([x[0] for x in lanes]), tree_stack([x[1] for x in lanes])
        stamps = torch.tensor([x[2] for x in lanes], dtype=torch.float32)
        states, outs = fleet.fleet_step(states, clouds, imus, stamps, FLEET_CFG)
        assert outs.lm_iters.shape == (2, 3)
        assert torch.equal(outs.lm_iters[:, :2], counted[-1])
        assert (outs.lm_iters[:, 2] == STATIC_BODIES).all()
    assert int(out.lm_iters[0]) >= 1


def test_lm_bodies_run_reaches_timing_json(tmp_path, monkeypatch):
    """The CLI's ``timing.json`` holds ``counter.lm_bodies_run`` under
    ``trace``: on the CPU's masked loop the static count a scan."""
    seq = _seq(9, N_SCANS)
    write_sequence(str(tmp_path / "seq.slog"), seq)
    monkeypatch.setattr(run, "SlamConfig", lambda **kw: dataclasses.replace(TEST_CONFIG, **kw))
    run.main(["--log", str(tmp_path / "seq.slog"), "--no-loop", "--out-dir",
              str(tmp_path / "out"), "--device", "cpu"])
    timing = json.loads((tmp_path / "out" / "timing.json").read_text())
    bodies = timing["trace"]["counter.lm_bodies_run"]
    scans = (tmp_path / "out" / "pose_evo.txt").read_text().splitlines()
    assert bodies["count"] == timing["scan"]["count"] == len(scans) >= 2
    assert bodies["max"] == bodies["mean"] == STATIC_BODIES


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and their events have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_stages_tile_the_graph(cuda, seq, fresh):
    """Each replayed call's stages, in order, sum to the graph's span
    (first mark to last) within 1%; the replay's parts are timed."""
    _run(seq, NO_LOOPS, trace=True, device=cuda)
    replayed = [r for r in fresh.records if r.stages]
    assert [r.call for r in replayed] == list(range(1, N_SCANS))
    for r in replayed:
        assert list(r.stages) == STAGES + ["state_copy"]
        graph_ms = r.device["graph"]
        assert graph_ms > 0 and abs(sum(r.stages.values()) - graph_ms) <= 0.01 * graph_ms
        assert r.device["call"] >= graph_ms and min(r.device.values()) >= 0
        assert [s.name for s in r.spans] == ["process", "copy_in", "launch", "clone", "pose_read"]


@pytest.mark.gpu
def test_marks_change_no_replay(cuda, seq, fresh):
    """A replay of a graph with marks is bit-equal to one without."""
    on = _run(seq, CFG, trace=True, device=cuda)
    off = _run(seq, CFG, trace=False, device=cuda)
    assert on._step.graphs[0].marks and not off._step.graphs[0].marks
    _assert_same(on, off)
