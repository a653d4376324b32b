"""tests/test_aux.py's paths that no other port test holds: the first-frame
pose from ``init_x/y/z/yaw``, ``io.export.compose_map_pose`` and the
profiling tools, each through the port and the JAX package.

* The init pose (tests/test_aux.py:164-183's config and scan, TEST_CONFIG
  with ``init_x=2, init_y=-1, init_z=0.5, init_yaw=0.5``) through one
  ``slam_step`` of each package, in both branches of
  ``models/odometry.py:348-353``:

  - ``use_imu=False`` (the JAX test's case): the first ``t_odom`` and yaw
    equal the config within 1e-5 and JAX's within 1e-5;
  - ``use_imu=True``: the yaw is the IMU filter's first yaw plus
    ``init_yaw``, so it differs from the same scan's yaw at ``init_yaw=0``
    by 0.5 within 1e-5 while pitch and roll stay; ``t_odom`` equals the
    config, and the pose JAX's, within 1e-5.
* ``compose_map_pose`` on seeded draws (64 map->odom poses and odometry
  poses up to 5 m out, where float32 spaces values by at most 4.8e-7):
  within 1e-6 of JAX's, and of tests/test_aux.py's closed form on its own
  example.
* ``StageTimer``, ``TicToc`` and ``Metrics`` as tests/test_aux.py:149-160
  uses them, beside the JAX module's on the same calls.
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
from rgc_slam_tpu.io.export import compose_map_pose as j_compose
from rgc_slam_tpu.models import slam as jslam
from rgc_slam_tpu.utils import math3d as jm3
from rgc_slam_tpu.utils import profiling as jprof
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud, imu_from_interval as t_imu
from rgc_slam_tpu_torch.io.export import compose_map_pose as t_compose
from rgc_slam_tpu_torch.models import slam as tslam
from rgc_slam_tpu_torch.utils import math3d as tm3
from rgc_slam_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)
INIT = dict(init_x=2.0, init_y=-1.0, init_z=0.5, init_yaw=0.5)
ATOL = 1e-5


@pytest.fixture(scope="module")
def first_scan():
    seq = synthetic.generate_sequence(
        n_scans=3, n_azimuth=120, seed=6, extent=15.0, radius=6.0,
        closes_loop=False, speed=1.5,
    )
    t_i, acc, gyr = seq["imu"][0]
    return seq["scans"][0], (t_i, acc, gyr), float(seq["stamps"][0])


def _port_first(first_scan, **kw):
    """The port's first ``slam_step`` output at TEST_CONFIG with ``kw``."""
    scan, (t_i, acc, gyr), stamp = first_scan
    cfg = dataclasses.replace(TCFG, **kw)
    _, out = tslam.slam_step(tslam.SlamState.init(cfg, "cpu"), t_cloud(scan, cfg, "cpu"),
                             t_imu(t_i, acc, gyr, cfg.max_imu, "cpu"),
                             torch.tensor(stamp, dtype=torch.float32), cfg)
    return out.t_odom.numpy(), tm3.quat_to_ypr(out.q_odom).numpy()


def _jax_first(first_scan, **kw):
    scan, (t_i, acc, gyr), stamp = first_scan
    cfg = dataclasses.replace(JCFG, **kw)
    step = jax.jit(functools.partial(jslam.slam_step, cfg=cfg))
    _, out = step(jslam.SlamState.init(cfg), j_cloud(scan, cfg), j_imu(t_i, acc, gyr, cfg.max_imu),
                  jnp.asarray(stamp, jnp.float32))
    return np.asarray(out.t_odom), np.asarray(jm3.quat_to_ypr(out.q_odom))


@pytest.mark.parametrize("use_imu", [False, True])
def test_init_pose_config(first_scan, use_imu):
    t_odom, ypr = _port_first(first_scan, use_imu=use_imu, **INIT)
    j_t_odom, j_ypr = _jax_first(first_scan, use_imu=use_imu, **INIT)
    expected_t = [INIT["init_x"], INIT["init_y"], INIT["init_z"]]
    np.testing.assert_allclose(t_odom, expected_t, atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_odom, j_t_odom, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ypr, j_ypr, atol=ATOL, rtol=0)
    if use_imu:
        # ypr0 + init_yaw: the same scan at init_yaw=0 gives the filter's yaw
        _, ypr0 = _port_first(first_scan, use_imu=True, **{**INIT, "init_yaw": 0.0})
        assert abs(ypr[0] - ypr0[0] - INIT["init_yaw"]) <= ATOL, (ypr, ypr0)
        np.testing.assert_allclose(ypr[1:], ypr0[1:], atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(ypr, [INIT["init_yaw"], 0.0, 0.0], atol=ATOL, rtol=0)


def test_compose_map_pose():
    # tests/test_aux.py:139-146's example against its closed form
    q_md = tm3.ypr_to_quat(torch.tensor([0.3, 0.0, 0.0]))
    t_md = torch.tensor([1.0, 2.0, 0.0])
    q, t = t_compose(q_md, t_md, tm3.quat_identity(), torch.tensor([1.0, 0.0, 0.0]))
    expected = t_md + tm3.quat_rotate(q_md, torch.tensor([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(t.numpy(), expected.numpy(), atol=1e-6)
    # seeded draws against JAX
    g = np.random.default_rng(0)
    n = 64
    ypr = g.uniform([-3.1, -0.5, -0.5], [3.1, 0.5, 0.5], (n, 2, 3)).astype(np.float32)
    t_md, t_odom = g.uniform(-5, 5, (2, n, 3)).astype(np.float32)
    q_md = np.array(jax.vmap(jm3.ypr_to_quat)(jnp.asarray(ypr[:, 0])))
    q_odom = np.array(jax.vmap(jm3.ypr_to_quat)(jnp.asarray(ypr[:, 1])))
    jq, jt = jax.vmap(j_compose)(*map(jnp.asarray, (q_md, t_md, q_odom, t_odom)))
    tq, tt = t_compose(*map(torch.from_numpy, (q_md, t_md, q_odom, t_odom)))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(tq.numpy(), axis=1), 1.0, atol=1e-6)


def test_profiling_tools():
    summaries, series = [], []
    for prof, work in ((tprof, lambda: torch.ones((64, 64)).sum()),
                       (jprof, lambda: jnp.sum(jnp.ones((64, 64))).block_until_ready())):
        timer = prof.StageTimer(budget_ms=1e9)
        tt = prof.TicToc()
        with timer.stage("work"):
            work()
        assert tt.toc() >= 0.0
        s = timer.summary()
        assert "work" in s and s["work"]["count"] == 1
        m = prof.Metrics()
        m.log(0, fitness=0.12, n_corr=500)
        m.log(1, fitness=0.10)
        assert m.series("fitness").shape == (2,)
        summaries.append({k: (sorted(v), v["count"]) for k, v in s.items()})
        series.append((m.series("fitness"), m.series("n_corr"), m.records))
    assert summaries[0] == summaries[1]
    (t_fit, t_corr, t_recs), (j_fit, j_corr, j_recs) = series
    np.testing.assert_array_equal(t_fit, j_fit)
    np.testing.assert_array_equal(t_corr, j_corr)
    assert t_recs == j_recs
