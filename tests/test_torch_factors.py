"""ops/factors of the port against the JAX module, and the Jacobians the
solvers take of them.

Residuals within 1e-5 relative to their scale on random inputs; the
forward-mode Jacobian of the mapping's Huber-weighted residuals against
``jax.jacfwd`` of the JAX residuals, for ``"huber"`` (the weight is held
constant: ``stop_gradient`` / ``detach``) and ``"l1"`` (differentiated).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.models import mapping as jmap
from rgc_slam_tpu.ops import factors as jf
from rgc_slam_tpu.types import GroundPlane as JG
from rgc_slam_tpu.utils import math3d as jm
from rgc_slam_tpu_torch.models import mapping as tmap
from rgc_slam_tpu_torch.ops import factors as tf
from rgc_slam_tpu_torch.types import GroundPlane as TG
from rgc_slam_tpu_torch.utils import math3d as tm

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(t, j, rtol=1e-5):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * max(np.abs(j).max(), 1.0))


def _quat(rng, s):
    return np.asarray(jm.quat_exp(jnp.asarray(rng.normal(0, s, 3), jnp.float32)))


def _plane(rng):
    n = rng.normal(size=3) * 0.05 + [0, 0, 1.0]
    n /= np.linalg.norm(n)
    v1 = np.cross(n, [0, 1.0, 0]); v1 /= np.linalg.norm(v1)
    v2 = np.cross(n, v1)
    vals = {k: np.asarray(v, np.float32) for k, v in
            dict(normal=n, v1=v1, v2=v2, distance=0.56, source=0.1).items()}
    vals["valid"] = np.asarray(True)
    return JG(**{k: jnp.asarray(v) for k, v in vals.items()}), TG(**{k: _t(v) for k, v in vals.items()})


@pytest.mark.parametrize("seed", range(3))
def test_residuals_match(seed):
    rng = np.random.default_rng(seed)
    q1, q2, q3, q4 = (_quat(rng, 0.3) for _ in range(4))
    t1, t2, p, pa, pb = (rng.normal(0, 2, 3).astype(np.float32) for _ in range(5))
    jg1, tg1 = _plane(rng)
    jg2, tg2 = _plane(rng)
    J, T = jnp.asarray, _t
    _close(tf.delta_r_residual(T(q1), T(q2), 0.05), jf.delta_r_residual(J(q1), J(q2), 0.05))
    _close(tf.relative_r_residual(T(q1), T(q2), T(q3), 0.4),
           jf.relative_r_residual(J(q1), J(q2), J(q3), 0.4))
    _close(tf.delta_p_residual(T(t1), T(t2), 0.02), jf.delta_p_residual(J(t1), J(t2), 0.02))
    _close(tf.ground_delta_residual(T(q1), T(t1), tg1, tg2, T(q3), 0.2),
           jf.ground_delta_residual(J(q1), J(t1), jg1, jg2, J(q3), 0.2))
    _close(tf.ground_goable_residual(T(q1), T(t1), T(q2), T(t2), tg1, tg2, T(q4), 0.2),
           jf.ground_goable_residual(J(q1), J(t1), J(q2), J(t2), jg1, jg2, J(q4), 0.2))
    _close(tf.pitchroll_residual(T(q1), 0.01, -0.02, 0.02),
           jf.pitchroll_residual(J(q1), 0.01, -0.02, 0.02))
    _close(tf.edge_residual(T(q1), T(t1), T(p), T(pa), T(pb), 0.7),
           jf.edge_residual(J(q1), J(t1), J(p), J(pa), J(pb), 0.7))
    n = pa / np.linalg.norm(pa)
    _close(tf.plane_norm_residual(T(q1), T(t1), T(p), T(n), 0.3, 0.9),
           jf.plane_norm_residual(J(q1), J(t1), J(p), J(n), 0.3, 0.9))
    s = rng.uniform(0, 0.05, 64).astype(np.float32)
    _close(tf.huber_rho(T(s)), jf.huber_rho(J(s)))


@pytest.mark.parametrize("loss", ["huber", "l1"])
def test_huber_weight_jacobian_semantics(rng, loss):
    """d/dδ of the plane residuals at a pose update δ: with "huber" the IRLS
    weight is a constant (Ceres corrector parity), with "l1" it is not."""
    n = 200
    pts = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = rng.normal(0, 0.3, n).astype(np.float32)             # many beyond the 0.1 band
    w = rng.uniform(0.5, 2, n).astype(np.float32)
    q0 = _quat(rng, 0.1)
    t0 = rng.normal(0, 1, 3).astype(np.float32)

    def jres(x):
        q = jm.quat_normalize(jm.quat_mul(jm.quat_exp(x[:3]), jnp.asarray(q0)))
        corr = jmap.PlaneCorr(n=jnp.asarray(nrm), d=jnp.asarray(d), w=jnp.asarray(w))
        return jmap._plane_residuals(q, jnp.asarray(t0) + x[3:], jnp.asarray(pts), corr, loss)

    def tres(x, c):
        xx = x[None, :]
        q = tm.quat_normalize(tm.quat_mul(tm.quat_exp(xx[:, :3]), c["q0"]))
        return tmap._plane_residuals(q, c["t0"] + xx[:, 3:], c["pts"], c["corr"], loss)

    consts = dict(q0=_t(q0), t0=_t(t0), pts=_t(pts),
                  corr=tmap.PlaneCorr(n=_t(nrm), d=_t(d), w=_t(w)))
    x0 = np.zeros(6, np.float32)
    Jj = np.asarray(jax.jacfwd(jres)(jnp.asarray(x0)))
    Jt = tf.jacobian(tres, _t(x0), consts).numpy()
    _close(Jt, Jj, rtol=1e-4)
    _close(tres(_t(x0), consts).numpy(), jres(jnp.asarray(x0)), rtol=1e-5)


def test_degeneracy_projection_matches(rng):
    """A residual stack blind to two directions: both packages project
    them out of the update."""
    A = rng.normal(size=(40, 6)).astype(np.float32)
    A[:, 4:] = 0.0
    b = rng.normal(size=40).astype(np.float32)
    jP, jn = jf.degeneracy_projection(lambda x: jnp.asarray(A) @ x + jnp.asarray(b), 6, 1e-3)
    tP, tn = tf.degeneracy_projection(lambda x, c: c["A"] @ x + c["b"], 6, 1e-3,
                                      dict(A=_t(A), b=_t(b)))
    assert int(tn) == int(jn) == 2
    _close(tP.numpy(), jP, rtol=1e-4)


def test_ceres_lm_matches_on_a_curved_problem(rng):
    """Rosenbrock-like residuals where steps get rejected: the same fixed
    iteration count lands on the same point."""
    a = rng.uniform(0.5, 1.5, 4).astype(np.float32)

    def jr(x):
        return jnp.concatenate([10.0 * (x[1:] - x[:-1] ** 2 - 0.1), 1.0 - x - jnp.asarray(a)])

    def tr(x, c):
        return torch.cat([10.0 * (x[1:] - x[:-1] ** 2 - 0.1), 1.0 - x - c["a"]])

    jx = jf.ceres_lm(jr, lambda x: 0.5 * jnp.sum(jr(x) ** 2), 4, iterations=8)
    tx = tf.ceres_lm(tr, lambda x, c: 0.5 * (tr(x, c) ** 2).sum(), 4, iterations=8,
                     consts=dict(a=_t(a)))
    _close(tx.numpy(), jx, rtol=1e-4)


@pytest.mark.parametrize("seed", range(3))
def test_library_residuals_match(seed):
    """The factors the engine does not call: the 3-point plane, the xy and z
    priors and the 15-dim IMU preintegration residual."""
    rng = np.random.default_rng(seed)
    q1, q2, q3 = (_quat(rng, 0.3) for _ in range(3))
    t1, t2, p, pj, pl, pm, v1, v2 = (rng.normal(0, 2, 3).astype(np.float32) for _ in range(8))
    ba1, bg1, ba2, bg2, dp, dv = (rng.normal(0, 0.05, 3).astype(np.float32) for _ in range(6))
    J, T = jnp.asarray, _t
    _close(tf.plane_3pt_residual(T(q1), T(t1), T(p), T(pj), T(pl), T(pm)),
           jf.plane_3pt_residual(J(q1), J(t1), J(p), J(pj), J(pl), J(pm)))
    _close(tf.imu_delta_p_residual(T(t1), T(t2), T(p), 0.5),
           jf.imu_delta_p_residual(J(t1), J(t2), J(p), 0.5))
    _close(tf.ground_z_residual(T(t1), T(t2), 2.0), jf.ground_z_residual(J(t1), J(t2), 2.0))
    dt = np.float32(rng.uniform(0.05, 0.2))
    args = (t1, q1, v1, ba1, bg1, t2, q2, v2, ba2, bg2, dp, q3, dv)
    r_t = tf.imu_preint_residual(*(T(a) for a in args), T(dt))
    r_j = jf.imu_preint_residual(*(J(a) for a in args), J(dt))
    assert r_t.shape == (15,) and r_t.dtype == torch.float32
    _close(r_t, r_j)


def _gn_problem(rng):
    """A mildly nonlinear 6-dim least squares with row weights spanning 10x
    (wider spans leave the float32 normal equations themselves uncertain
    beyond 1e-5, in both packages)."""
    A = rng.normal(size=(30, 6)).astype(np.float32)
    A[:5] *= 10.0
    b = rng.normal(size=30).astype(np.float32)
    return A, b


@pytest.mark.parametrize("case", ["plain", "project", "clip"])
def test_gauss_newton_matches(rng, case):
    A, b = _gn_problem(rng)
    P = np.diag([1, 1, 1, 1, 0, 0]).astype(np.float32) if case == "project" else None
    clip = 0.05 if case == "clip" else 1.0

    def jr(x):
        return jnp.asarray(A) @ x + jnp.asarray(b) + 0.3 * jnp.sin(jnp.asarray(A[:, :1]) @ x[:1])

    def tr(x):
        return _t(A) @ x + _t(b) + 0.3 * torch.sin(_t(A[:, :1]) @ x[:1])

    jx = jf.gauss_newton(jr, 6, 5, step_clip=clip, project=None if P is None else jnp.asarray(P))
    tx = tf.gauss_newton(tr, 6, 5, step_clip=clip, project=None if P is None else _t(P),
                         device="cpu")
    assert tx.dtype == torch.float32 and tx.shape == (6,)
    assert np.abs(np.asarray(jx)).max() > 1e-3                   # it moved
    if P is not None:
        assert float(tx[4:].abs().max()) == 0.0
    _close(tx.numpy(), jx)
