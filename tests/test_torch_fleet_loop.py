"""parallel/fleet's loop closure in the port against the JAX package's fleet
and the port's single stream, on the CPU.

* ``fleet_loop_step`` on three robots in three situations at once (no
  candidate, a candidate that the ICP rejects, an accepted loop with its
  PGO), each built by tests/test_torch_loop.py's ``_circle_store`` and
  bridged from JAX: every lane's ``LoopInfo`` flags and candidate, and its
  loop store's indices, exactly as JAX's ``fleet_loop_step`` and the port's
  own ``loop_closure_step`` give them; floats with test_torch_loop.py's
  tolerances (fitness 1e-3 relative, poses and loop fields 1e-4);
* ``make_fleet_chunk_step`` against per-scan dispatch (``fleet_step`` and
  ``fleet_loop_step`` at the cadence): equal to 1e-6 when the chunk divides
  the cadence, and through its exact-cadence fallback when the chunk
  exceeds it; ``_needs_exact_cadence`` equal to JAX's over a grid.
"""
import dataclasses
import functools

import numpy as np
import jax
import pytest
import torch

from rgc_slam_tpu.parallel import fleet as jfleet
from rgc_slam_tpu_torch import bridge
from rgc_slam_tpu_torch.models import loop as tloop
from rgc_slam_tpu_torch.parallel import fleet
from rgc_slam_tpu_torch.types import tree_index, tree_stack
from test_torch_loop import (LOOP_FLOAT_FIELDS, LOOP_INT_FIELDS, _assert_loop_states, _cfgs,
                             _circle_store, _sd)

torch.set_num_threads(1)
SITUATIONS = {            # _circle_store arguments -> (attempted, accepted)
    "no candidate": (dict(n_kf=20), (True, False)),
    "rejected": (dict(yaw_drift=1e-2), (True, False)),
    "accepted": (dict(), (True, True)),
}


def test_fleet_loop_step_mixed_lanes():
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, inline_compaction=False)
    tcfg = dataclasses.replace(tcfg, inline_compaction=False)
    pairs = [_circle_store(jcfg, **kw) for kw, _ in SITUATIONS.values()]
    jstates = jax.tree.map(lambda *x: jax.numpy.stack(x), *[p[0] for p in pairs])
    jls = jax.tree.map(lambda *x: jax.numpy.stack(x), *[p[1] for p in pairs])
    js, jl, jinfo = jax.jit(functools.partial(jfleet.fleet_loop_step, cfg=jcfg))(jstates, jls)

    ts, tl, tinfo = fleet.fleet_loop_step(bridge.fleet_state_from_numpy(_sd(jstates), tcfg, "cpu"),
                                          bridge.fleet_loop_state_from_numpy(_sd(jls), tcfg, "cpu"),
                                          tcfg)
    assert tinfo.accepted.shape == (len(SITUATIONS),)
    j_np, t_np = _sd(js), bridge.state_to_numpy(ts)
    for b, (name, (_, (attempted, accepted))) in enumerate(SITUATIONS.items()):
        assert (bool(tinfo.attempted[b]), bool(tinfo.accepted[b])) == (attempted, accepted), name
        single = tloop.loop_closure_step(bridge.state_from_numpy(_sd(pairs[b][0]), tcfg, "cpu"),
                                         bridge.loop_state_from_numpy(_sd(pairs[b][1]), tcfg, "cpu"),
                                         tcfg)
        s_np = bridge.state_to_numpy(single[0])
        for f in ("attempted", "accepted", "candidate", "pgo_ran"):
            lane = getattr(tinfo, f)[b].item()
            assert lane == np.asarray(getattr(jinfo, f))[b].item() == getattr(single[2], f).item(), \
                (name, f)
        for ref in (float(np.asarray(jinfo.fitness)[b]), float(single[2].fitness)):
            assert abs(float(tinfo.fitness[b]) - ref) <= 1e-3 * abs(ref), (name, ref)
        _assert_loop_states(tree_index(tl, b), jax.tree.map(lambda x: x[b], jl))
        lane_ls, single_ls = (bridge.loop_state_to_numpy(x) for x in (tree_index(tl, b), single[1]))
        for f in LOOP_INT_FIELDS:
            np.testing.assert_array_equal(lane_ls[f], single_ls[f], err_msg=(name, f))
        for f in LOOP_FLOAT_FIELDS:
            np.testing.assert_allclose(lane_ls[f], single_ls[f], atol=1e-4, rtol=0, err_msg=(name, f))
        for k in ("mapping.kf_t", "mapping.kf_q", "mapping.t_md", "mapping.q_md",
                  "mapping.t_w_last", "mapping.q_w_last"):
            np.testing.assert_allclose(t_np[k][b], j_np[k][b], atol=1e-4, rtol=0, err_msg=(name, k))
            np.testing.assert_allclose(t_np[k][b], s_np[k], atol=1e-4, rtol=0, err_msg=(name, k))
        assert int(t_np["mapping.kf_count"][b]) == int(j_np["mapping.kf_count"][b])
    moved = np.abs(t_np["mapping.kf_t"][2] - _sd(pairs[2][0])["mapping.kf_t"]).max()
    assert moved > 0.02, moved                           # the accepting lane's PGO ran
    for b in (0, 1):                                     # the others' stores are untouched
        np.testing.assert_array_equal(t_np["mapping.kf_t"][b], _sd(pairs[b][0])["mapping.kf_t"])


# ---------------------------------------------------------------------------
# chunked dispatch with loop closure folded in
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chunk_inputs():
    from rgc_slam_tpu_torch.io import synthetic
    from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval

    _, tcfg = _cfgs(inline_compaction=False, loop_cadence=2, max_loops=4)
    seqs = [synthetic.generate_sequence(n_scans=5, n_azimuth=120, seed=s, extent=15.0, radius=6.0,
                                        noise=0.004, closes_loop=False, speed=1.5) for s in (7, 8)]
    steps = []
    for k in range(4):
        lanes = []
        for seq in seqs:
            t_i, acc, gyr = seq["imu"][k]
            lanes.append((cloud_from_scan_dict(seq["scans"][k], tcfg, "cpu"),
                          imu_from_interval(t_i, acc, gyr, tcfg.max_imu, "cpu"),
                          torch.tensor(seq["stamps"][k], dtype=torch.float32)))
        steps.append([tree_stack([lane[j] for lane in lanes]) for j in range(3)])
    return tcfg, steps


@pytest.fixture(scope="module")
def per_dispatch(chunk_inputs):
    tcfg, steps = chunk_inputs
    states, ls = fleet.fleet_init(tcfg, 2, "cpu"), fleet.fleet_loop_init(tcfg, 2, "cpu")
    outs = []
    for k, batch in enumerate(steps):
        states, out = fleet.fleet_step(states, *batch, tcfg)
        outs.append(out.t_map)
        if (k + 1) % tcfg.loop_cadence == 0:
            states, ls, _ = fleet.fleet_loop_step(states, ls, tcfg)
    return states, ls, torch.stack(outs)


@pytest.mark.parametrize("chunk", [2, 4])       # 2 divides the cadence, 4 > cadence (exact path)
def test_fleet_chunk_step_matches_per_dispatch(chunk_inputs, per_dispatch, chunk):
    tcfg, steps = chunk_inputs
    assert fleet._needs_exact_cadence(tcfg, chunk) == (chunk == 4)
    ref_states, ref_ls, ref_outs = per_dispatch
    step = fleet.make_fleet_chunk_step(tcfg, chunk)
    states, ls = fleet.fleet_init(tcfg, 2, "cpu"), fleet.fleet_loop_init(tcfg, 2, "cpu")
    counter = torch.tensor(0, dtype=torch.int32)
    outs = []
    for k0 in range(0, len(steps), chunk):
        flat = [x for j in range(chunk) for x in steps[k0 + j]]
        states, ls, counter, chunk_outs = step(states, ls, counter, *flat)
        outs.extend(o.t_map for o in chunk_outs)
    assert int(counter) == len(steps)
    torch.testing.assert_close(torch.stack(outs), ref_outs, atol=1e-6, rtol=0)
    assert torch.equal(ls.last_kf_count, ref_ls.last_kf_count)     # the loop step ran twice
    assert torch.equal(ls.loop_count, ref_ls.loop_count)
    torch.testing.assert_close(states.mapping.kf_t, ref_states.mapping.kf_t, atol=1e-6, rtol=0)
    assert torch.equal(states.mapping.kf_count, ref_states.mapping.kf_count)


def test_fleet_chunk_fires_once_at_chunk_end(chunk_inputs):
    """cadence 2, chunk 2 from counter 1: the boundary at scan 2 lies inside
    the chunk, and the loop step runs once, at its end."""
    tcfg, steps = chunk_inputs
    calls = []
    real = fleet.fleet_loop_step

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    step = fleet.make_fleet_chunk_step(tcfg, 2)
    states, ls = fleet.fleet_init(tcfg, 2, "cpu"), fleet.fleet_loop_init(tcfg, 2, "cpu")
    fleet.fleet_loop_step = spy
    try:
        _, _, counter, _ = step(states, ls, torch.tensor(1, dtype=torch.int32),
                                *[x for j in range(2) for x in steps[j]])
        assert calls == [1] and int(counter) == 3
        step(states, ls, torch.tensor(2, dtype=torch.int32), *[x for j in range(2) for x in steps[j]])
        assert calls == [1, 1]                           # 2 -> 4 crosses scan 4
    finally:
        fleet.fleet_loop_step = real


def test_needs_exact_cadence_matches_jax():
    jcfg, tcfg = _cfgs()
    for cadence in range(1, 21):
        for chunk in range(1, 25):
            j = jfleet._needs_exact_cadence(dataclasses.replace(jcfg, loop_cadence=cadence), chunk)
            t = fleet._needs_exact_cadence(dataclasses.replace(tcfg, loop_cadence=cadence), chunk)
            assert t == j, (cadence, chunk)
