"""The reference's own pieces: the vectorized scan-to-map solve against the
frozen C++ transliteration it follows (``reference/oracles.py``), the IMU
rotation, the TF32 rounding, and the seeded sample of window calls."""
import math

import numpy as np
import pytest
import torch

from slambench.drivers.slam_system import Reservoir
from slambench.reference import oracles, stages
from slambench.reference.precision import FLOAT64, tf32_np, tf32_torch


def _rot(yaw, pitch=0.0, roll=0.0):
    """(x, y, z, w) of R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    return np.array([sr * cp * cy - cr * sp * sy, cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy, cr * cp * cy + sr * sp * sy])


def _to_sensor(p_world, q, t):
    qc = np.array([-q[0], -q[1], -q[2], q[3]])
    return np.stack([oracles._quat_rotate_xyzw(qc, p - t) for p in p_world])


def _fixture(seed=17):
    """A map of vertical edges and three walls, two feature scans at known
    poses, and starts a few centimetres and milliradians off."""
    rs = np.random.RandomState(seed)
    lines = []
    for cx, cy in rs.uniform(-12, 12, (10, 2)):
        z = np.arange(-1.0, 2.0, 0.07)
        lines.append(np.stack([np.full_like(z, cx), np.full_like(z, cy), z], 1))
    corner_map = np.concatenate(lines) + rs.normal(0, 0.004, (len(lines) * len(z), 3))
    ex, ey, ez = np.eye(3)

    def plane(n, span, base, a, b):
        uv = rs.uniform(-span, span, (n, 2))
        return base + uv[:, :1] * a + uv[:, 1:] * b

    surf_map = np.concatenate([plane(300, 6.0, np.array([14.0, 0, 0.5]), ey, ez),
                               plane(300, 6.0, np.array([0, -10.0, 0.5]), ex, ez),
                               plane(400, 10.0, np.array([0, 0, -1.5]), ex, ey)])
    surf_map += rs.normal(0, 0.004, surf_map.shape)
    poses = {"cur": (_rot(0.3, 0.02, -0.03), np.array([1.0, -0.5, 0.1])),
             "last": (_rot(0.27, 0.018, -0.025), np.array([0.8, -0.45, 0.09]))}
    feats = {}
    for key, (q, t) in poses.items():
        c = corner_map[rs.choice(len(corner_map), 40)] + rs.normal(0, 0.01, (40, 3))
        s = surf_map[rs.choice(len(surf_map), 80)] + rs.normal(0, 0.01, (80, 3))
        feats[key] = (_to_sensor(c, q, t), rs.uniform(0.6, 1.4, 40),
                      _to_sensor(s, q, t), rs.uniform(0.6, 1.4, 80))
    q0 = oracles._quat_mul_xyzw(_rot(0.008, -0.005, 0.006), poses["cur"][0])
    ql0 = oracles._quat_mul_xyzw(_rot(-0.004, 0.003, -0.002), poses["last"][0])
    return dict(corner_map=corner_map, surf_map=surf_map, feats=feats, poses=poses,
                x0=[q0, poses["cur"][1] + [0.04, -0.03, 0.02], ql0,
                    poses["last"][1] + [-0.02, 0.015, -0.01]])


def test_vectorized_solve_follows_the_oracle():
    fx = _fixture()
    (qc, tc), (ql, tl) = fx["poses"]["cur"], fx["poses"]["last"]
    dq = oracles._quat_mul_xyzw(np.array([-ql[0], -ql[1], -ql[2], ql[3]]), qc)
    ypr_c, ypr_l = (oracles._quat2euler_lidarfactor(q) for q in (qc, ql))
    g = {"normal": np.array([0.0, 0.0, 1.0]), "v1": np.array([1.0, 0.0, 0.0]),
         "v2": np.array([0.0, 1.0, 0.0])}
    g_last, g_cur, g_last2 = ({**g, "distance": d} for d in (1.59, 1.58, 1.60))
    q_hist = _rot(0.1)
    q_w_last2, t_w_last2 = _rot(0.24, 0.015, -0.02), np.array([0.6, -0.4, 0.08])
    c, c_conf, s, s_conf = fx["feats"]["cur"]
    cl, cl_conf, sl, sl_conf = fx["feats"]["last"]
    want = oracles.reference_mapping_solve(
        c, c_conf, s, s_conf, cl, cl_conf, sl, sl_conf, fx["corner_map"], fx["surf_map"],
        *fx["x0"], delta_q_imu=dq, imu_cov=0.4, imu_pr=(ypr_c[1], ypr_c[2]),
        imu_pr_last=(ypr_l[1], ypr_l[2]),
        grounds=(g_last, g_cur, q_hist, g_last2, q_hist, q_w_last2, t_w_last2), outer_iters=2)

    T = lambda a: torch.as_tensor(np.asarray(a, np.float64))          # noqa: E731
    plane = lambda p: {k: T(v) for k, v in p.items()}                  # noqa: E731
    feats = {"corner": (T(c), T(c_conf)), "corner_last": (T(cl), T(cl_conf)),
             "surf": (T(s), T(s_conf)), "surf_last": (T(sl), T(sl_conf))}
    masks = {k: torch.ones(len(v[0]), dtype=torch.bool) for k, v in feats.items()}
    imu = (T(dq), 0.4, (T(ypr_c[1]), T(ypr_c[2])), (T(ypr_l[1]), T(ypr_l[2])))
    grounds = (plane(g_last), plane(g_cur), T(q_hist), plane(g_last2), T(q_hist), T(q_w_last2),
               T(t_w_last2))
    q, t = stages.solve(feats, masks, T(fx["corner_map"]), T(fx["surf_map"]),
                        [T(x) for x in fx["x0"]], imu, grounds, 2, FLOAT64)
    assert float(np.abs(t.numpy() - want["t"]).max()) < 1e-7
    assert stages.angle_between(q, T(want["q"])) < 1e-7
    # and the solve did its work: the start was 4-5 cm off
    assert float(np.abs(t.numpy() - tc).max()) < 0.01


def test_imu_rotation_integrates_the_gyro():
    t = np.arange(1, 21) / 200.0
    gyr = np.tile([0.0, 0.0, 0.3], (20, 1))
    q = stages.imu_rotation(t, gyr, 0.0, np.array([0.0, 0.0, 0.1]))
    angle = 2.0 * math.atan2(float(torch.linalg.vector_norm(q[:3])), float(q[3]))
    assert angle == pytest.approx(0.2 * 0.1, rel=1e-6)


def test_tf32_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 24.3456789, -7.123456], np.float32)
    want = np.array([1.0, 1.0, 1.0 + 2**-9, 24.34375, -7.125], np.float32)
    assert np.array_equal(tf32_np(x), want)
    assert np.array_equal(tf32_torch(torch.from_numpy(x)).numpy(), want)
    y = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    assert np.abs(tf32_np(y) - y).max() <= np.abs(y).max() * 2**-11


def test_reservoir_samples_every_call_alike():
    def draw(seed, n=50, k=8):
        r = Reservoir(k, seed)
        for i in range(n):
            slot = r.slot()
            if slot >= 0:
                r.put(slot, i)
        return sorted(r.items)

    assert draw(3) == draw(3) and len(draw(3)) == 8 and len(set(draw(3))) == 8
    assert draw(3, n=5) == [0, 1, 2, 3, 4]
    counts = np.bincount(np.concatenate([draw(s) for s in range(2000)]), minlength=50)
    assert counts.min() > 0.7 * counts.mean() and counts.max() < 1.3 * counts.mean()
