"""The slice as a whole: the port's slam_step / SlamSystem against JAX.

The sequence is tests/test_mapping.py's (31 scans, 360 azimuth, seed 5,
TEST_CONFIG).  Float32 rounding differences are amplified by the reference
itself: where the VGICP LM stops at its iteration cap while its
correspondence set oscillates (scan 5 here), a one-ulp change of the JAX
package's own input moves its pose by 2.5e-4 m in that step and by up to
~6e-2 m after 30 scans.  So the port is held to the reference's measured
self-sensitivity: a one-step gate is ``max(1e-4, 2 x env)`` and the
sequence gate ``max(5e-3 m, 2 x env)``, with ``env`` the JAX package's
deviation from itself under 1e-7 relative perturbations of the scans,
measured in this test; the scans before scan 5 are held to 5e-3 m alone.  The port's ATE is held to the
0.1 m gate of tests/test_mapping.py and to 1.05 x the JAX ATE + 0.01 m.
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
from rgc_slam_tpu.models import slam as jslam
from rgc_slam_tpu.utils.evaluation import ate_rmse
from rgc_slam_tpu_torch import bridge
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud, imu_from_interval as t_imu
from rgc_slam_tpu_torch.models import slam as tslam

torch.set_num_threads(1)
CARRY = (3, 5)
BIFURCATION = 5          # first scan whose VGICP LM stops at its cap oscillating
PERTURB_SEEDS = (1, 2)


def _jax_state_dict(state):
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in leaves}


def _perturbed(scan, seed):
    g = np.random.default_rng(seed)
    s = dict(scan)
    s["xyz"] = (scan["xyz"] * (1 + 1e-7 * g.standard_normal(scan["xyz"].shape))).astype(np.float32)
    return s


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(
        n_scans=31, n_azimuth=360, seed=5, extent=18.0, radius=8.0,
        noise=0.004, motion_distortion=True, closes_loop=False, speed=2.0,
    )


def _jax_inputs(seq, k, scan=None):
    t_i, acc, gyr = seq["imu"][k]
    return (j_cloud(scan if scan is not None else seq["scans"][k], JCFG),
            j_imu(t_i, acc, gyr, JCFG.max_imu), jnp.asarray(seq["stamps"][k], jnp.float32))


@pytest.fixture(scope="module")
def jax_runs(seq):
    """The JAX trajectory, the same run on perturbed scans (per seed), and
    the JAX states before the CARRY steps."""
    step = jax.jit(functools.partial(jslam.slam_step, cfg=JCFG))

    def run(seed=None):
        state = jslam.SlamState.init(JCFG)
        traj, carried = [], {}
        for k, scan in enumerate(seq["scans"]):
            if k in CARRY:
                carried[k] = state
            s = scan if seed is None else _perturbed(scan, seed)
            state, out = step(state, *_jax_inputs(seq, k, s))
            traj.append((np.asarray(out.t_map), np.asarray(out.q_map)))
        return traj, carried

    base, carried = run()
    env = np.zeros(len(seq["scans"]))
    for seed in PERTURB_SEEDS:
        pert, _ = run(seed)
        env = np.maximum(env, [np.abs(a[0] - b[0]).max() for a, b in zip(pert, base)])
    return step, base, carried, env


@pytest.fixture(scope="module")
def port_run(seq):
    system = tslam.SlamSystem(TCFG, enable_loop=False, device="cpu")
    for k, scan in enumerate(seq["scans"]):
        t_i, acc, gyr = seq["imu"][k]
        system.process(t_cloud(scan, TCFG, "cpu"), t_imu(t_i, acc, gyr, TCFG.max_imu, "cpu"),
                       seq["stamps"][k])
    return system


@pytest.mark.parametrize("n_carry", CARRY)
def test_one_step_from_carried_state(seq, jax_runs, n_carry):
    """JAX state after n_carry scans -> bridge -> one step in each package."""
    step, base, carried, _ = jax_runs
    jstate = carried[n_carry]
    _, jout = step(jstate, *_jax_inputs(seq, n_carry))
    env_t = env_q = 0.0
    for seed in PERTURB_SEEDS + (3,):
        _, p = step(jstate, *_jax_inputs(seq, n_carry, _perturbed(seq["scans"][n_carry], seed)))
        env_t = max(env_t, float(np.abs(np.asarray(p.t_map) - np.asarray(jout.t_map)).max()))
        env_q = max(env_q, float(np.abs(np.asarray(p.q_map) - np.asarray(jout.q_map)).max()))

    tstate = bridge.state_from_numpy(_jax_state_dict(jstate), TCFG, "cpu")
    np.testing.assert_array_equal(bridge.state_to_numpy(tstate)["mapping.kf_surf"],
                                  np.asarray(jstate.mapping.kf_surf))
    t_i, acc, gyr = seq["imu"][n_carry]
    tstate2, tout = tslam.slam_step(
        tstate, t_cloud(seq["scans"][n_carry], TCFG, "cpu"),
        t_imu(t_i, acc, gyr, TCFG.max_imu, "cpu"),
        torch.tensor(seq["stamps"][n_carry], dtype=torch.float32), TCFG)
    dt = np.abs(tout.t_map.numpy() - np.asarray(jout.t_map)).max()
    dq = np.abs(tout.q_map.numpy() - np.asarray(jout.q_map)).max()
    assert dt <= max(1e-4, 2 * env_t), (dt, env_t)
    assert dq <= max(1e-4, 2 * env_q), (dq, env_q)
    assert int(tstate2.mapping.kf_count) == int(np.asarray(jstate.mapping.kf_count)) + int(tout.kf_added)


def test_sequence_tracks_jax(seq, jax_runs, port_run):
    _, base, _, env = jax_runs
    j_t = np.stack([t for t, _ in base])
    p_t = tslam.trajectory_xyz(port_run)
    assert p_t.shape == j_t.shape and np.isfinite(p_t).all()
    dev = np.abs(p_t - j_t).max(1)
    # before the first LM-cap bifurcation of this sequence (scan 5) the
    # fixed bound holds; over the whole sequence the port stays within
    # twice the reference's own largest deviation from itself
    assert (dev[:BIFURCATION] <= 5e-3).all(), dev[:BIFURCATION]
    assert dev.max() <= max(5e-3, 2 * env.max()), (dev.max(), env.max())
    gt = np.stack([t for (_, t) in seq["poses"]])
    ate_port, ate_jax = ate_rmse(p_t, gt), ate_rmse(j_t, gt)
    assert ate_port < 0.1, ate_port
    assert ate_port <= 1.05 * ate_jax + 0.01, (ate_port, ate_jax)
    kf = int(port_run.state.mapping.kf_count)
    assert 3 <= kf <= len(seq["scans"])


def test_dump_tum_and_unported_options(seq, port_run, tmp_path):
    path = tmp_path / "traj.txt"
    port_run.dump_tum(str(path))
    rows = np.loadtxt(path)
    assert rows.shape == (len(port_run.trajectory), 8)
    np.testing.assert_allclose(rows[:, 1:4], tslam.trajectory_xyz(port_run), atol=1e-6)
    looped = tslam.SlamSystem(TCFG, device="cpu")     # loop closure on by default
    assert looped.enable_loop and int(looped.loop_state.loop_count) == 0
    assert tslam.SlamSystem(TCFG, enable_loop=False, device="cpu").loop_state is None
    # chunked dispatch and checkpoints are ported (tests/test_torch_chunk.py,
    # tests/test_torch_checkpoint.py), and so are the rbf covariances
    # (tests/test_torch_rbf.py): every option runs
    for enable_loop in (False, True):
        assert tslam.SlamSystem(TCFG, enable_loop=enable_loop, chunk=2, device="cpu").chunk == 2
    rbf = tslam.SlamSystem(dataclasses.replace(TCFG, cov_estimation="rbf"), enable_loop=False,
                           device="cpu")
    t_i, acc, gyr = seq["imu"][0]
    out = rbf.process(t_cloud(seq["scans"][0], TCFG, "cpu"), t_imu(t_i, acc, gyr, 64, "cpu"),
                      seq["stamps"][0])
    assert bool(torch.isfinite(out.t_map).all())


def test_slam_system_defaults_to_the_card():
    """Without a device argument the state goes to CUDA: with no CUDA
    device torch raises, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default cannot fail here")
    for enable_loop in (False, None):                  # None: the config's, loops on
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
            tslam.SlamSystem(TCFG, enable_loop=enable_loop)
    assert tslam.SlamSystem(TCFG, enable_loop=False, device="cpu").state.odo.frame.device.type == "cpu"


def test_mapping_skip_frame(seq):
    """mapping_skip_frame=2: skipped scans reuse the map->odom correction."""
    jcfg = dataclasses.replace(JCFG, mapping_skip_frame=2)
    tcfg = dataclasses.replace(TCFG, mapping_skip_frame=2)
    step = jax.jit(functools.partial(jslam.slam_step, cfg=jcfg))
    jstate = jslam.SlamState.init(jcfg)
    tstate = tslam.SlamState.init(tcfg, "cpu")
    for k in range(3):
        jstate, jout = step(jstate, *_jax_inputs(seq, k))
        t_i, acc, gyr = seq["imu"][k]
        tstate, tout = tslam.slam_step(
            tstate, t_cloud(seq["scans"][k], tcfg, "cpu"), t_imu(t_i, acc, gyr, 64, "cpu"),
            torch.tensor(seq["stamps"][k], dtype=torch.float32), tcfg)
        assert bool(tout.kf_added) == bool(jout.kf_added)
        assert np.abs(tout.t_map.numpy() - np.asarray(jout.t_map)).max() < 5e-3
    assert int(tstate.mapping.count) == int(jstate.mapping.count) == 2


def test_degeneracy_projection_config(seq):
    """degeneracy_thresh > 0 (the mapping solve projected off the weak
    directions of JᵀJ; at 200 two of the twelve here): ``SlamSystem``
    runs it, and tracks JAX as the scans before the bifurcation do."""
    jcfg = dataclasses.replace(JCFG, degeneracy_thresh=200.0)
    tcfg = dataclasses.replace(TCFG, degeneracy_thresh=200.0)
    step = jax.jit(functools.partial(jslam.slam_step, cfg=jcfg))
    jstate = jslam.SlamState.init(jcfg)
    system = tslam.SlamSystem(tcfg, enable_loop=False, device="cpu")
    for k in range(3):
        jstate, jout = step(jstate, *_jax_inputs(seq, k))
        t_i, acc, gyr = seq["imu"][k]
        tout = system.process(t_cloud(seq["scans"][k], tcfg, "cpu"),
                              t_imu(t_i, acc, gyr, tcfg.max_imu, "cpu"), seq["stamps"][k])
        assert bool(tout.kf_added) == bool(jout.kf_added)
        assert np.abs(tout.t_map.numpy() - np.asarray(jout.t_map)).max() < 5e-3


def test_keyframes_accumulate_and_travel_monotone(seq, port_run):
    """tests/test_mapping.py:54 and :65 on the port's run: the first scan is
    a keyframe, keyframes lie more than 0.3 m apart (the 0.5 m / 0.3 rad
    gate), and the travel accumulators strictly increase."""
    ms = port_run.state.mapping
    n_kf = int(ms.kf_count)
    assert 3 <= n_kf <= len(seq["scans"])
    kf_t = ms.kf_t[:n_kf].numpy()
    np.testing.assert_allclose(kf_t[0], port_run.trajectory[0][2], atol=1e-6)
    assert (np.linalg.norm(np.diff(kf_t, axis=0), axis=1) > 0.3).all()
    assert (np.diff(ms.kf_travel[:n_kf].numpy()) > 0).all()
