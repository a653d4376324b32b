"""parallel/fleet of the port against the JAX package's fleet and the port's
own single stream, on the CPU (the loop-closure half is in
tests/test_torch_fleet_loop.py).

Three robots: two worlds (tests/test_fleet.py's sequence, seeds 7 and 8),
the first on lanes 0 and 2, over 3 scans at TEST_CONFIG with
``inline_compaction=False`` (as fleets run).  Gates:

* each lane against JAX ``fleet.fleet_step`` on the same inputs: 5e-3 m at
  every scan (tests/test_torch_slam.py's early-scan gate);
* each lane against the port's ``slam_step`` on its world: 1e-4 m
  (tests/test_fleet.py:52), or twice the single stream's own deviation
  under 1e-7 relative perturbations of the scans where that is larger: a
  batched reduction rounds differently, and the step amplifies a rounding
  difference where its LM path flips (scan 2 of seed 7 here: the single
  stream moves by 8.7e-5 m under such a perturbation, the lane differs
  from it by 1.5e-4 m and from the JAX fleet's lane by 3e-7 m);
* lanes with the same inputs: 1e-6 m;
* compaction: counts, masks and the kept keyframes exactly as JAX's
  ``compact_fleet`` on the same bridged state.

Everything runs with the vmap fallback off (``fleet`` uses
``utils.lanes.strict_vmap``), so an operator without a batching rule fails.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud, imu_from_interval as j_imu
from rgc_slam_tpu.models.mapping import COMPACT_MARGIN as J_MARGIN
from rgc_slam_tpu.parallel import fleet as jfleet
from rgc_slam_tpu_torch import bridge
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud, imu_from_interval as t_imu
from rgc_slam_tpu_torch.models import slam as tslam
from rgc_slam_tpu_torch.models.mapping import COMPACT_MARGIN
from rgc_slam_tpu_torch.parallel import fleet
from rgc_slam_tpu_torch.types import tree_items, tree_map, tree_stack

torch.set_num_threads(1)
SEEDS = (7, 8)
LANES = (0, 1, 0)            # world of each robot
N_SCANS = 3
JF = dataclasses.replace(JCFG, inline_compaction=False)
TF = dataclasses.replace(TCFG, inline_compaction=False)


def _sd(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in leaves}


def _perturbed(scan, seed):
    g = np.random.default_rng(seed)
    s = dict(scan)
    s["xyz"] = (scan["xyz"] * (1 + 1e-7 * g.standard_normal(scan["xyz"].shape))).astype(np.float32)
    return s


@pytest.fixture(scope="module")
def seqs():
    return [synthetic.generate_sequence(
        n_scans=N_SCANS + 1, n_azimuth=120, seed=s, extent=15.0, radius=6.0, noise=0.004,
        closes_loop=False, speed=1.5) for s in SEEDS]


def _j_inputs(seq, k, scan=None):
    t_i, acc, gyr = seq["imu"][k]
    return (j_cloud(scan or seq["scans"][k], JF), j_imu(t_i, acc, gyr, JF.max_imu),
            jnp.asarray(seq["stamps"][k], jnp.float32))


def _t_inputs(seq, k):
    t_i, acc, gyr = seq["imu"][k]
    return (t_cloud(seq["scans"][k], TF, "cpu"), t_imu(t_i, acc, gyr, TF.max_imu, "cpu"),
            torch.tensor(seq["stamps"][k], dtype=torch.float32))


def _t_batch(seqs, k):
    lanes = [_t_inputs(seqs[w], k) for w in LANES]
    return [tree_stack([lane[j] for lane in lanes]) for j in range(3)]


@pytest.fixture(scope="module")
def port_fleet(seqs):
    states = fleet.fleet_init(TF, len(LANES), "cpu")
    traj = []
    for k in range(N_SCANS):
        states, outs = fleet.fleet_step(states, *_t_batch(seqs, k), TF)
        traj.append(outs.t_map.numpy())
    return states, np.stack(traj, 1)                     # [B, scans, 3]


@pytest.fixture(scope="module")
def jax_fleet(seqs):
    """JAX fleet_step on the same lanes."""
    fstep = jax.jit(functools.partial(jfleet.fleet_step, cfg=JF))
    states = jfleet.fleet_init(JF, len(LANES))
    traj = []
    for k in range(N_SCANS):
        lanes = [_j_inputs(seqs[w], k) for w in LANES]
        batch = [jax.tree.map(lambda *x: jnp.stack(x), *[lane[j] for lane in lanes]) for j in range(3)]
        states, outs = fstep(states, *batch)
        traj.append(np.asarray(outs.t_map))
    return states, np.stack(traj, 1)


def test_fleet_matches_jax_fleet(port_fleet, jax_fleet):
    _, p_traj = port_fleet
    _, j_traj = jax_fleet
    assert p_traj.shape == j_traj.shape == (len(LANES), N_SCANS, 3)
    dev = np.abs(p_traj - j_traj).max(-1)
    assert (dev <= 5e-3).all(), dev
    assert np.abs(p_traj[:, -1, :2]).max() > 0.1         # the robots moved


def _perturbed_t(seq, k, seed):
    t_i, acc, gyr = seq["imu"][k]
    return (t_cloud(_perturbed(seq["scans"][k], seed), TF, "cpu"),
            t_imu(t_i, acc, gyr, TF.max_imu, "cpu"), torch.tensor(seq["stamps"][k], dtype=torch.float32))


def test_fleet_lanes_match_single_streams(seqs, port_fleet):
    states, p_traj = port_fleet
    np.testing.assert_allclose(p_traj[0], p_traj[2], atol=1e-6)   # same inputs, same lane result

    def single(seq, seed=None):
        state, traj = tslam.SlamState.init(TF, "cpu"), []
        for k in range(N_SCANS):
            inputs = _t_inputs(seq, k) if seed is None else _perturbed_t(seq, k, seed)
            state, out = tslam.slam_step(state, *inputs, TF)
            traj.append(out.t_map.numpy())
        return state, np.stack(traj)

    for w, seq in enumerate(seqs):
        state, traj = single(seq)
        env = np.max([np.abs(single(seq, s)[1] - traj).max(1) for s in (1, 2)], 0)
        dev = np.abs(p_traj[w] - traj).max(1)
        assert (dev <= np.maximum(1e-4, 2 * env)).all(), (w, dev, env)
        assert int(states.mapping.kf_count[w]) == int(state.mapping.kf_count)


def test_fleet_state_bridge(jax_fleet):
    """The JAX fleet's batched leaves -> the port's fleet state, and back."""
    jstates = jax_fleet[0]
    arrays = _sd(jstates)
    tstates = bridge.fleet_state_from_numpy(arrays, TF, "cpu")
    assert tstates.mapping.kf_q.shape == (len(LANES), TF.max_keyframes, 4)
    back = bridge.state_to_numpy(tstates)
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    init = dict(tree_items(fleet.fleet_init(TF, 2, "cpu")))
    assert init["odo.sub_xyz"].data_ptr() != init["odo.sub_xyz"][1].data_ptr()
    assert init["odo.sub_xyz"].stride(0) > 0            # real copies, not an expand


def _store(cfg_j, counts):
    """tests/test_fleet.py's fleet: robot stores filled to ``counts``."""
    K = cfg_j.max_keyframes
    B = len(counts)
    states = jfleet.fleet_init(cfg_j, B)
    kf_t = jnp.tile(jnp.arange(K, dtype=jnp.float32)[None, :, None], (B, 1, 3))
    mask = jnp.tile((jnp.arange(K) % 3 == 0)[None, :, None], (B, 1, cfg_j.max_kf_surf))
    return states.replace(mapping=states.mapping.replace(
        kf_count=jnp.asarray(counts, jnp.int32), kf_t=kf_t, kf_surf_mask=mask,
        kf_travel=jnp.tile(jnp.arange(K, dtype=jnp.float32)[None], (B, 1))))


def test_compact_fleet_matches_jax():
    """Robots at, near and far below the margin: only the ones within it
    are thinned, exactly as JAX thins them; the others stay bit-exact."""
    jcfg = dataclasses.replace(JF, max_keyframes=64)
    tcfg = dataclasses.replace(TF, max_keyframes=64)
    K = 64
    assert COMPACT_MARGIN == J_MARGIN
    counts = [K - 2, K - COMPACT_MARGIN - 1, 0, K - COMPACT_MARGIN]
    jstates = _store(jcfg, counts)
    jout = jax.jit(jfleet.compact_fleet)(jstates)
    tstates = bridge.fleet_state_from_numpy(_sd(jstates), tcfg, "cpu")
    tout = fleet.compact_fleet(tstates)
    t_np, j_np = bridge.state_to_numpy(tout), _sd(jout)
    for k in ("mapping.kf_count", "mapping.kf_t", "mapping.kf_travel", "mapping.kf_surf_mask",
              "mapping.kf_q"):
        np.testing.assert_array_equal(t_np[k], j_np[k], err_msg=k)
    c = t_np["mapping.kf_count"]
    assert c[0] < K - 2 and c[3] < K - COMPACT_MARGIN, c
    assert c[1] == K - COMPACT_MARGIN - 1 and c[2] == 0, c
    before = bridge.state_to_numpy(tstates)
    for k, v in t_np.items():                         # the robots below the margin: untouched
        np.testing.assert_array_equal(v[1:3], before[k][1:3], err_msg=k)


def test_fleet_step_compacting(seqs, monkeypatch):
    """Below the margin: bit-exact with fleet_step.  A robot at the margin
    is compacted within the same step, the other one is not;
    compact_fleet_if_needed dispatches only at the margin."""
    jcfg = dataclasses.replace(JF, max_keyframes=64)
    tcfg = dataclasses.replace(TF, max_keyframes=64)
    K = 64
    batch = [tree_map(lambda v: v[:2], x) for x in _t_batch(seqs, 0)]

    def states(c0, c1):
        return bridge.fleet_state_from_numpy(_sd(_store(jcfg, [c0, c1])), tcfg, "cpu")

    a, out_a = fleet.fleet_step(states(K - COMPACT_MARGIN - 2, 4), *batch, tcfg)
    b, out_b = fleet.fleet_step_compacting(states(K - COMPACT_MARGIN - 2, 4), *batch, tcfg)
    for (k, x), (_, y) in zip(tree_items(a), tree_items(b)):
        assert torch.equal(x, y), k
    assert torch.equal(out_a.t_map, out_b.t_map)
    c, _ = fleet.fleet_step_compacting(states(K - 2, 4), *batch, tcfg)
    counts = c.mapping.kf_count.tolist()
    assert counts[0] < K - 2 and counts[1] <= 5, counts

    calls = []
    compact = fleet.compact_fleet

    def spy(s):
        calls.append(1)
        return compact(s)

    monkeypatch.setattr(fleet, "compact_fleet", spy)
    below = states(K - COMPACT_MARGIN - 1, 0)
    assert fleet.compact_fleet_if_needed(below) is below and not calls
    at = states(K - COMPACT_MARGIN, 0)
    out = fleet.compact_fleet_if_needed(at)
    assert calls == [1] and int(out.mapping.kf_count[0]) < K - COMPACT_MARGIN
    assert bool(fleet._near_capacity(at.mapping.kf_count, K))
    assert not bool(fleet._near_capacity(below.mapping.kf_count, K))
