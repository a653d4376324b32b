"""``imu.preintegrate_full`` and ``imu_cov_mode="preint"`` of the port against JAX.

* ``preintegrate_full`` on the same windows and biases: every field (the
  deltas, the 15x15 covariance and bias Jacobian) within
  tests/test_torch_imu.py's preintegration tolerance, 1e-5 absolute +
  1e-5 relative;
* one ``odometry_step`` at ``imu_cov_mode="preint"`` from the same carried
  JAX state: tests/test_torch_odometry.py's gates (each float output within
  ``max(1e-4, 2 x env)``, ``env`` the JAX step's own deviation under 1e-7
  relative perturbations of the scan; the IMU rotation within 1e-6).
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
from rgc_slam_tpu.models import odometry as jodo
from rgc_slam_tpu.models import slam as jslam
from rgc_slam_tpu.ops import features as jF
from rgc_slam_tpu.ops import imu as ji
from rgc_slam_tpu_torch import bridge
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud, imu_from_interval as t_imu
from rgc_slam_tpu_torch.models import odometry as todo
from rgc_slam_tpu_torch.ops import features as tF
from rgc_slam_tpu_torch.ops import imu as ti

torch.set_num_threads(1)
FIELDS = {"q_w": 1e-4, "t_w": 1e-4, "q_rel": 1e-4, "t_rel": 1e-4, "fitness": 1e-4}
STEP = 3


@pytest.fixture(scope="module")
def windows():
    poses = synthetic.make_trajectory(24, radius=8.0, speed=2.0, closes_loop=False)
    return synthetic.synthesize_imu(poses, 0.1)


@pytest.mark.parametrize("k", [1, 7, 15])
def test_preintegrate_full_matches(windows, rng, k):
    t, acc, gyr = windows[k]
    t0 = float(t[0]) - 0.004
    ba = rng.normal(0, 0.05, 3).astype(np.float32)
    bg = rng.normal(0, 0.005, 3).astype(np.float32)
    noise = dict(acc_n=0.08, gyr_n=0.004, acc_w=4e-5, gyr_w=2e-6) if k != 7 else \
        dict(acc_n=0.2, gyr_n=0.01, acc_w=1e-3, gyr_w=1e-4)
    # a window cut short: the padded samples must leave every output alone
    n = len(t) if k != 15 else len(t) // 2
    jp = ji.preintegrate_full(j_imu(t[:n], acc[:n], gyr[:n], 64), jnp.float32(t0),
                              jnp.float32(t[n - 1]), jnp.asarray(ba), jnp.asarray(bg), **noise)
    tp = ti.preintegrate_full(t_imu(t[:n], acc[:n], gyr[:n], 64, "cpu"),
                              torch.tensor(t0, dtype=torch.float32), torch.tensor(float(t[n - 1])),
                              torch.from_numpy(ba), torch.from_numpy(bg), **noise)
    assert tp._fields == jp._fields
    for name, a, b in zip(jp._fields, tp, jp):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5, err_msg=name)
    assert float(tp.cov[3:6, 3:6].diagonal().min()) > 0          # a real rotation variance


def _jax_state_dict(state):
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in leaves}


def _perturbed(scan, seed):
    g = np.random.default_rng(seed)
    s = dict(scan)
    s["xyz"] = (scan["xyz"] * (1 + 1e-7 * g.standard_normal(scan["xyz"].shape))).astype(np.float32)
    return s


def test_odometry_step_preint_matches():
    jcfg = dataclasses.replace(JCFG, imu_cov_mode="preint")
    tcfg = dataclasses.replace(TCFG, imu_cov_mode="preint")
    seq = synthetic.generate_sequence(n_scans=STEP + 2, n_azimuth=360, seed=5, extent=18.0,
                                      radius=8.0, noise=0.004, motion_distortion=True,
                                      closes_loop=False, speed=2.0)
    step = jax.jit(functools.partial(jslam.slam_step, cfg=jcfg))
    state = jslam.SlamState.init(jcfg)
    for k in range(STEP):
        t_i, acc, gyr = seq["imu"][k]
        state, _ = step(state, j_cloud(seq["scans"][k], jcfg), j_imu(t_i, acc, gyr, jcfg.max_imu),
                        jnp.asarray(seq["stamps"][k], jnp.float32))
    scan, (t_i, acc, gyr), stamp = seq["scans"][STEP], seq["imu"][STEP], seq["stamps"][STEP]
    feat = jax.jit(functools.partial(jF.extract_features, cfg=jcfg))
    odo = jax.jit(functools.partial(jodo.odometry_step, cfg=jcfg))
    jimu, jstamp = j_imu(t_i, acc, gyr, jcfg.max_imu), jnp.asarray(stamp, jnp.float32)

    def jax_out(s):
        return odo(state.odo, feat(j_cloud(s, jcfg)), jimu, jstamp)[1]

    jout = jax_out(scan)
    env = dict.fromkeys(FIELDS, 0.0)
    for seed in (1, 2):
        p = jax_out(_perturbed(scan, seed))
        for f in FIELDS:
            env[f] = max(env[f], float(np.abs(np.asarray(getattr(p, f))
                                             - np.asarray(getattr(jout, f))).max()))

    tstate = bridge.state_from_numpy(_jax_state_dict(state), tcfg, "cpu").odo
    tfx = tF.extract_features(t_cloud(scan, tcfg, "cpu"), tcfg)
    _, tout = todo.odometry_step(tstate, tfx, t_imu(t_i, acc, gyr, tcfg.max_imu, "cpu"),
                                 torch.tensor(stamp, dtype=torch.float32), tcfg)
    for f, tol in FIELDS.items():
        dev = np.abs(getattr(tout, f).numpy() - np.asarray(getattr(jout, f))).max()
        assert dev <= max(tol, 2 * env[f]), (f, dev, env[f])
    np.testing.assert_allclose(tout.delta_q_imu.numpy(), np.asarray(jout.delta_q_imu), atol=1e-6)
    assert int(tout.gflag) == int(jout.gflag)


@pytest.mark.parametrize("k", [1, 7])
def test_bias_corrected_delta_matches(windows, rng, k):
    """The first-order bias update on the same ``PreintegrationFull``:
    (delta_q, delta_p, delta_v) within 1e-6."""
    t, acc, gyr = windows[k]
    jp = ji.preintegrate_full(j_imu(t, acc, gyr, 64), jnp.float32(t[0] - 0.004),
                              jnp.float32(t[-1]), jnp.zeros(3), jnp.zeros(3))
    tp = ti.PreintegrationFull(*(torch.from_numpy(np.array(x)) for x in jp))
    dba = rng.normal(0, 0.05, 3).astype(np.float32)
    dbg = rng.normal(0, 0.005, 3).astype(np.float32)
    got = ti.bias_corrected_delta(tp, torch.from_numpy(dba), torch.from_numpy(dbg))
    want = ji.bias_corrected_delta(jp, jnp.asarray(dba), jnp.asarray(dbg))
    for name, a, b in zip(("delta_q", "delta_p", "delta_v"), got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6, err_msg=name)
    # the update moved the deltas toward a re-preintegration at the new biases
    again = ji.preintegrate_full(j_imu(t, acc, gyr, 64), jnp.float32(t[0] - 0.004),
                                 jnp.float32(t[-1]), jnp.asarray(dba), jnp.asarray(dbg))
    moved = np.abs(np.asarray(again.delta_p) - np.asarray(jp.delta_p)).max()
    left = np.abs(np.asarray(again.delta_p) - got[1].numpy()).max()
    assert left < 0.1 * moved, (left, moved)
