"""ops/imu of the port against the JAX module on the same IMU windows.

Gates are the JAX suite's complementary-filter oracle gates: roll/pitch
within 2e-4 rad and the per-window yaw increment within 2e-5 rad; the
preintegrated deltas and gravity init within 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import imu_from_interval as j_imu
from rgc_slam_tpu.ops import imu as ji
from rgc_slam_tpu_torch.io.convert import imu_from_interval as t_imu
from rgc_slam_tpu_torch.ops import imu as ti

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def windows():
    # 24 windows of 20 samples: past the 300-sample gain switch and the
    # 356-sample warm-up, so the bias initialization runs too
    poses = synthetic.make_trajectory(24, radius=8.0, speed=2.0, closes_loop=False)
    return synthetic.synthesize_imu(poses, 0.1)


def _np(x):
    return np.asarray(x)


def test_complementary_filter_matches(windows):
    js = ji.ImuFilterState.init()
    ts = ti.ImuFilterState.init("cpu")
    prev_yaw = (0.0, 0.0)
    for t, acc, gyr in windows:
        js = ji.complementary_filter_scan(js, j_imu(t, acc, gyr, 64))
        ts = ti.complementary_filter_scan(ts, t_imu(t, acc, gyr, 64, "cpu"))
        assert abs(float(ts.roll) - float(js.roll)) < 2e-4
        assert abs(float(ts.pitch) - float(js.pitch)) < 2e-4
        dj, dt = float(js.yaw) - prev_yaw[0], float(ts.yaw) - prev_yaw[1]
        assert abs(dt - dj) < 2e-5
        prev_yaw = (float(js.yaw), float(ts.yaw))
        for f in ("count", "warm_n", "bias_ready"):
            assert _np(getattr(ts, f)) == _np(getattr(js, f)), f
    assert bool(ts.bias_ready)
    for f in ("ba", "bg", "bufx", "bufy", "bufz", "warm_acc", "warm_gyr"):
        np.testing.assert_allclose(_np(getattr(ts, f)), _np(getattr(js, f)),
                                   atol=1e-5, rtol=0, err_msg=f)


def test_static_bias(rng):
    acc = (np.array([0.1, -0.2, 9.8]) + rng.normal(0, 0.05, (256, 3))).astype(np.float32)
    gyr = rng.normal(0, 0.01, (256, 3)).astype(np.float32)
    acc[::17] += 3.0                                 # non-static samples
    mask = rng.random(256) > 0.1
    jout = ji.estimate_static_bias(jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(mask), 32)
    tout = ti.estimate_static_bias(torch.from_numpy(acc), torch.from_numpy(gyr),
                                   torch.from_numpy(mask), 32)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(_np(t), _np(j), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        _np(ti.check_static(torch.from_numpy(acc), torch.from_numpy(gyr))),
        _np(ji.check_static(jnp.asarray(acc), jnp.asarray(gyr))))


@pytest.mark.parametrize("k", [1, 7, 15])
def test_preintegrate_and_gravity_init(windows, rng, k):
    t, acc, gyr = windows[k]
    t0 = float(t[0]) - 0.004
    ba = rng.normal(0, 0.05, 3).astype(np.float32)
    bg = rng.normal(0, 0.005, 3).astype(np.float32)
    jp = ji.preintegrate(j_imu(t, acc, gyr, 64), jnp.float32(t0), jnp.float32(t[-1]),
                         jnp.asarray(ba), jnp.asarray(bg))
    tp = ti.preintegrate(t_imu(t, acc, gyr, 64, "cpu"), torch.tensor(t0, dtype=torch.float32),
                         torch.tensor(float(t[-1])), torch.from_numpy(ba), torch.from_numpy(bg))
    for j, tt in zip(jp, tp):
        np.testing.assert_allclose(_np(tt), _np(j), atol=1e-5, rtol=1e-5)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    t_ij = rng.normal(0, 0.2, 3).astype(np.float32)
    jg = ji.gravity_init(jp, jnp.asarray(q), jnp.asarray(t_ij), jnp.float32(0.1))
    tg = ti.gravity_init(tp, torch.from_numpy(q), torch.from_numpy(t_ij), torch.tensor(0.1))
    for j, tt in zip(jg, tg):
        np.testing.assert_allclose(_np(tt), _np(j), atol=1e-4, rtol=1e-5)
