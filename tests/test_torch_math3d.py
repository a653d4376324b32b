"""utils/math3d and utils/cloud of the port against the JAX modules.

Tolerance 2e-6 absolute: float32 elementwise formulas that both packages
write identically; only the rounding of transcendental functions differs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.utils import cloud as jc
from rgc_slam_tpu.utils import math3d as jm
from rgc_slam_tpu_torch.utils import cloud as tc
from rgc_slam_tpu_torch.utils import math3d as tm

torch.set_num_threads(1)
ATOL = 2e-6


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _check(jout, tout, atol=ATOL):
    np.testing.assert_allclose(np.asarray(tout), np.asarray(jout), atol=atol, rtol=0)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("fn", [
    "quat_normalize", "quat_conj", "quat_to_mat", "quat_to_ypr", "quat_log",
])
def test_unary_quat(rng, fn):
    q = _quats(rng, 64)
    q[:4] = [[1, 0, 0, 0], [-1, 0, 0, 0], [0, 1, 0, 0], [0.7071068, 0, 0.7071068, 0]]
    _check(getattr(jm, fn)(jnp.asarray(q)), getattr(tm, fn)(_t(q)))


def test_quat_mul_rotate(rng):
    a, b = _quats(rng, 64), _quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32) * 20
    _check(jm.quat_mul(jnp.asarray(a), jnp.asarray(b)), tm.quat_mul(_t(a), _t(b)))
    _check(jm.quat_rotate(jnp.asarray(a), jnp.asarray(v)),
           tm.quat_rotate(_t(a), _t(v)), atol=1e-5)
    # broadcasting one quaternion over many points
    _check(jm.quat_rotate(jnp.asarray(a[:1]), jnp.asarray(v)),
           tm.quat_rotate(_t(a[:1]), _t(v)), atol=1e-5)


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.5, 3.0])
def test_quat_exp_so3(rng, scale):
    w = (rng.normal(size=(64, 3)) * scale).astype(np.float32)
    _check(jm.quat_exp(jnp.asarray(w)), tm.quat_exp(_t(w)))
    _check(jm.so3_exp(jnp.asarray(w)), tm.so3_exp(_t(w)))


def test_mat_ypr_roundtrips(rng):
    ypr = rng.uniform(-3, 3, size=(64, 3)).astype(np.float32)
    ypr[:, 1] = np.clip(ypr[:, 1], -1.5, 1.5)
    R = np.asarray(jm.ypr_to_mat(jnp.asarray(ypr)))
    _check(jm.ypr_to_mat(jnp.asarray(ypr)), tm.ypr_to_mat(_t(ypr)))
    _check(jm.mat_to_ypr(jnp.asarray(R)), tm.mat_to_ypr(_t(R)), atol=1e-5)
    _check(jm.mat_to_quat(jnp.asarray(R)), tm.mat_to_quat(_t(R)), atol=1e-5)
    _check(jm.ypr_to_quat(jnp.asarray(ypr)), tm.ypr_to_quat(_t(ypr)), atol=1e-5)
    _check(jm.so3_log(jnp.asarray(R)), tm.so3_log(_t(R)), atol=1e-5)


def test_slerp_axis_angle_skew(rng):
    a, b = _quats(rng, 64), _quats(rng, 64)
    b[:8] = a[:8]                      # the lerp branch
    s = rng.uniform(-0.5, 1.5, 64).astype(np.float32)
    _check(jm.quat_slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(s)),
           tm.quat_slerp(_t(a), _t(b), _t(s)), atol=1e-5)
    axis = rng.normal(size=(64, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(-3, 3, 64).astype(np.float32)
    _check(jm.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(ang)),
           tm.quat_from_axis_angle(_t(axis), _t(ang)))
    _check(jm.skew(jnp.asarray(axis)), tm.skew(_t(axis)))


def test_angle_wraps_and_se3(rng):
    a = rng.uniform(-10, 10, 256).astype(np.float32)
    _check(jm.wrap_angle(jnp.asarray(a)), tm.wrap_angle(_t(a)), atol=1e-5)
    _check(jm.wrap_rollpitch(jnp.asarray(a)), tm.wrap_rollpitch(_t(a)), atol=1e-5)
    q = _quats(rng, 1)[0]
    t = rng.normal(size=3).astype(np.float32)
    p = rng.normal(size=(32, 3)).astype(np.float32)
    _check(jm.se3_apply(jnp.asarray(q), jnp.asarray(t), jnp.asarray(p)),
           tm.se3_apply(_t(q), _t(t), _t(p)), atol=1e-5)
    for jo, to in zip(jm.se3_inverse(jnp.asarray(q), jnp.asarray(t)),
                      tm.se3_inverse(_t(q), _t(t))):
        _check(jo, to)
    _check(jm.se3_mat(jnp.asarray(q), jnp.asarray(t)), tm.se3_mat(_t(q), _t(t)))


def test_cloud_helpers(rng):
    pts = rng.uniform(-90, 90, (500, 3)).astype(np.float32)
    pts[:20, 0] = -rng.uniform(0, 5, 20)
    pts[:20, 1] = rng.uniform(-0.4, 0.4, 20)             # the rear cone
    mask = rng.random(500) > 0.2
    np.testing.assert_array_equal(
        tc.range_filter_mask(_t(pts), _t(mask), 0.5, 80.0).numpy(),
        np.asarray(jc.range_filter_mask(jnp.asarray(pts), jnp.asarray(mask), 0.5, 80.0)))
    _check(jc.masked_centroid(jnp.asarray(pts), jnp.asarray(mask)),
           tc.masked_centroid(_t(pts), _t(mask)), atol=1e-4)
    q = _quats(rng, 1)[0]
    t = rng.normal(size=3).astype(np.float32)
    _check(jc.transform_points(jnp.asarray(q), jnp.asarray(t), jnp.asarray(pts)),
           tc.transform_points(_t(q), _t(t), _t(pts)), atol=1e-4)
    m2 = rng.random(300) > 0.5
    for cap in (600, 1000):
        jout = jc.concat_padded([jnp.asarray(pts), jnp.asarray(pts[:300])],
                                [jnp.asarray(mask), jnp.asarray(m2)], cap)
        tout = tc.concat_padded([_t(pts), _t(pts[:300])], [_t(mask), _t(m2)], cap)
        for j, o in zip(jout, tout):
            np.testing.assert_array_equal(o.numpy(), np.asarray(j))
