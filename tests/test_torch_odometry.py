"""models/odometry of the port against the JAX module.

* ``deskew_points`` within 1e-4 m and ``fusion_solve`` within 1e-4 (the JAX
  suite's deskew and fusion oracle gates) on the same inputs;
* the submap target voxel map: keys exactly, moments to float tolerance;
* per-scan ``OdometryOutput`` from the same carried JAX state.  The VGICP LM
  of some scans stops at its iteration cap while its correspondence set
  still oscillates, and there the reference itself moves by up to ~1e-2 m
  when its input changes by one float32 ulp.  So each float output is
  gated at ``max(tol, 2 x env)``, with ``env`` the JAX step's own deviation
  under 1e-7 relative perturbations of the scan (two seeds), measured here.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud, imu_from_interval as j_imu
from rgc_slam_tpu.models import odometry as jodo
from rgc_slam_tpu.models import slam as jslam
from rgc_slam_tpu.ops import features as jF
from rgc_slam_tpu.types import GroundPlane as JGround
from rgc_slam_tpu.utils import math3d as jm
from rgc_slam_tpu_torch import bridge
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud, imu_from_interval as t_imu
from rgc_slam_tpu_torch.models import odometry as todo
from rgc_slam_tpu_torch.ops import features as tF
from rgc_slam_tpu_torch.types import GroundPlane as TGround

torch.set_num_threads(1)
N_SCANS = 7
FIELDS = {"q_w": 1e-4, "t_w": 1e-4, "q_rel": 1e-4, "t_rel": 1e-4, "fitness": 1e-4}


def _jax_state_dict(state):
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in leaves}


def _t(x):
    return torch.from_numpy(np.array(x))


def test_deskew_points_matches(rng):
    xyz = rng.uniform(-30, 30, (4000, 3)).astype(np.float32)
    rel = rng.uniform(-0.2, 1.2, 4000).astype(np.float32)
    for angle in (1e-9, 0.02, 2.9):
        axis = rng.normal(size=3)
        q = np.asarray(jm.quat_exp(jnp.asarray(axis / np.linalg.norm(axis) * angle, jnp.float32)))
        t = rng.normal(0, 0.5, 3).astype(np.float32)
        j = jodo.deskew_points(jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(q), jnp.asarray(t))
        d = todo.deskew_points(_t(xyz), _t(rel), _t(q), _t(t))
        assert np.abs(d.numpy() - np.asarray(j)).max() <= 1e-4, angle


def _plane(rng, tilt):
    n = np.array([tilt * rng.normal(), tilt * rng.normal(), 1.0])
    n /= np.linalg.norm(n)
    v1 = np.cross(n, [0, 1.0, 0])
    v1 /= np.linalg.norm(v1)
    v2 = np.cross(n, v1)
    f = lambda a: np.asarray(a, np.float32)
    vals = dict(normal=f(n), v1=f(v1), v2=f(v2), distance=f(0.56 + 0.01 * rng.normal()),
                source=f(0.1), valid=np.asarray(True))
    return (JGround(**{k: jnp.asarray(v) for k, v in vals.items()}),
            TGround(**{k: _t(v) for k, v in vals.items()}))


@pytest.mark.parametrize("seed", range(6))
def test_fusion_solve_matches(seed):
    rng = np.random.default_rng(seed)
    q = lambda s: np.asarray(jm.quat_exp(jnp.asarray(rng.normal(0, s, 3), jnp.float32)))
    jg1, tg1 = _plane(rng, 0.02)
    jg2, tg2 = _plane(rng, 0.02)
    f32 = lambda x: np.float32(x)
    args = [q(0.02), rng.normal(0, 0.2, 3).astype(np.float32), f32(rng.uniform(0.01, 0.3)),
            None, None, q(0.01), q(0.02), f32(rng.choice([0.0005, 0.2])), f32(1.0), f32(1.0)]
    jargs = [jnp.asarray(a) if a is not None else None for a in args]
    jargs[3], jargs[4] = jg1, jg2
    targs = [_t(a) if a is not None else None for a in args]
    targs[3], targs[4] = tg1, tg2
    jq, jt = jodo.fusion_solve(*jargs)
    tq, tt = todo.fusion_solve(*targs)
    assert np.abs(tq.numpy() - np.asarray(jq)).max() <= 1e-4
    assert np.abs(tt.numpy() - np.asarray(jt)).max() <= 1e-4


@pytest.fixture(scope="module")
def carried():
    """JAX states before each of the first N_SCANS scans, plus the inputs."""
    seq = synthetic.generate_sequence(
        n_scans=N_SCANS + 1, n_azimuth=360, seed=5, extent=18.0, radius=8.0,
        noise=0.004, motion_distortion=True, closes_loop=False, speed=2.0,
    )
    step = jax.jit(functools.partial(jslam.slam_step, cfg=JCFG))
    state = jslam.SlamState.init(JCFG)
    states = []
    for k in range(N_SCANS):
        states.append(state)
        t_imu, acc, gyr = seq["imu"][k]
        state, _ = step(state, j_cloud(seq["scans"][k], JCFG),
                        j_imu(t_imu, acc, gyr, JCFG.max_imu),
                        jnp.asarray(seq["stamps"][k], jnp.float32))
    return seq, states


def test_submap_target_matches(carried):
    _, states = carried
    state = states[4].odo
    origin = jnp.floor(state.t_w)
    jvm = jodo._submap_target(state, JCFG, origin)
    tstate = bridge.state_from_numpy(_jax_state_dict(states[4]), TCFG, "cpu").odo
    tvm = todo._submap_target(tstate, TCFG, torch.floor(tstate.t_w))
    np.testing.assert_array_equal(tvm.keys.numpy(), np.asarray(jvm.keys))
    np.testing.assert_array_equal(tvm.num_points.numpy(), np.asarray(jvm.num_points))
    np.testing.assert_allclose(tvm.mean.numpy(), np.asarray(jvm.mean), atol=1e-5)
    np.testing.assert_allclose(tvm.cov.numpy(), np.asarray(jvm.cov), atol=1e-4)


def _perturbed(scan, seed):
    g = np.random.default_rng(seed)
    s = dict(scan)
    s["xyz"] = (scan["xyz"] * (1 + 1e-7 * g.standard_normal(scan["xyz"].shape))).astype(np.float32)
    return s


@pytest.mark.parametrize("k", range(1, N_SCANS))
def test_odometry_step_matches_per_scan(carried, k):
    seq, states = carried
    scan, (t_i, acc, gyr), stamp = seq["scans"][k], seq["imu"][k], seq["stamps"][k]
    feat = jax.jit(functools.partial(jF.extract_features, cfg=JCFG))
    odo = jax.jit(functools.partial(jodo.odometry_step, cfg=JCFG))
    jimu, jstamp = j_imu(t_i, acc, gyr, JCFG.max_imu), jnp.asarray(stamp, jnp.float32)

    def jax_out(s):
        return odo(states[k].odo, feat(j_cloud(s, JCFG)), jimu, jstamp)[1]

    jout = jax_out(scan)
    env = {f: 0.0 for f in FIELDS}
    env_n = 0
    for seed in (1, 2):
        p = jax_out(_perturbed(scan, seed))
        for f in FIELDS:
            env[f] = max(env[f], float(np.abs(np.asarray(getattr(p, f)) - np.asarray(getattr(jout, f))).max()))
        env_n = max(env_n, abs(int(p.n_corr) - int(jout.n_corr)))

    tstate = bridge.state_from_numpy(_jax_state_dict(states[k]), TCFG, "cpu").odo
    tfx = tF.extract_features(t_cloud(scan, TCFG, "cpu"), TCFG)
    _, tout = todo.odometry_step(tstate, tfx, t_imu(t_i, acc, gyr, TCFG.max_imu, "cpu"),
                                 torch.tensor(stamp, dtype=torch.float32), TCFG)
    for f, tol in FIELDS.items():
        dev = np.abs(getattr(tout, f).numpy() - np.asarray(getattr(jout, f))).max()
        assert dev <= max(tol, 2 * env[f]), (f, dev, env[f])
    assert abs(int(tout.n_corr) - int(jout.n_corr)) <= 2 * env_n
    # the IMU path and the deskew are deterministic given the state
    np.testing.assert_allclose(tout.delta_q_imu.numpy(), np.asarray(jout.delta_q_imu), atol=1e-6)
    np.testing.assert_allclose(tout.deskewed_sharp_xyz.numpy(),
                               np.asarray(jout.deskewed_sharp_xyz), atol=1e-4)
    assert bool(tout.ground.valid) == bool(jout.ground.valid)
    assert int(tout.gflag) == int(jout.gflag)
