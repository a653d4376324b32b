"""ops/registration of the port against the JAX module on the same inputs.

Gates are the JAX suite's VGICP oracle gates: identical correspondence
sets, H / b / cost within 1e-3 relative; for ``lm_register`` the same
outer-iteration count, accept/reject sequence and reject counts, λ within
1e-3 relative (but for the last iteration, see the test) and the final
pose within 1e-4.  The scene (three textured
planes) converges well inside the iteration cap, so the LM path is not
decided by float32 rounding.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.ops import registration as jr
from rgc_slam_tpu.ops import voxelhash as jv
from rgc_slam_tpu.utils import math3d as jm
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.ops import registration as tr
from rgc_slam_tpu_torch.types import VoxelMap

torch.set_num_threads(1)


def _scene(seed):
    """Floor + two walls with bumps, plane-regularized covariances."""
    g = np.random.default_rng(seed)
    n = 1500
    u, v = g.uniform(-8, 8, n), g.uniform(0, 3, n)
    floor = np.stack([g.uniform(-8, 8, n), g.uniform(-8, 8, n), 0.1 * np.sin(u)], 1)
    wall_x = np.stack([np.full(n, 6.0) + 0.1 * np.sin(2 * v), u, v], 1)
    wall_y = np.stack([u, np.full(n, -5.0) + 0.1 * np.cos(u), v], 1)
    pts = np.concatenate([floor, wall_x, wall_y]) + g.normal(0, 0.01, (3 * n, 3))
    normals = np.concatenate([np.tile([0, 0, 1.0], (n, 1)), np.tile([1.0, 0, 0], (n, 1)),
                              np.tile([0, 1.0, 0], (n, 1))])
    covs = np.eye(3)[None] - (1 - 1e-3) * normals[:, :, None] * normals[:, None, :]
    return pts.astype(np.float32), covs.astype(np.float32)


def _problem(seed, n_src=1024):
    pts, covs = _scene(seed)
    mask = np.ones(len(pts), bool)
    jvm = jv.build_gaussian_voxelmap(jnp.asarray(pts), jnp.asarray(covs), jnp.asarray(mask),
                                     1.0, JCFG.max_voxels)
    g = np.random.default_rng(seed + 100)
    sel = g.choice(len(pts), n_src, replace=False)
    q_true = np.asarray(jm.quat_exp(jnp.asarray([0.01, -0.02, 0.03], jnp.float32)))
    R = np.asarray(jm.quat_to_mat(jnp.asarray(q_true)))
    t_true = np.array([0.12, -0.08, 0.03])
    src = ((pts[sel] - t_true) @ R).astype(np.float32)       # src = T^-1 pts
    src_cov = np.einsum("ji,njk,kl->nil", R, covs[sel], R).astype(np.float32)
    src_mask = g.random(n_src) > 0.05
    tvm = VoxelMap(**{f: torch.from_numpy(np.array(getattr(jvm, f)))
                      for f in ("keys", "mean", "cov", "num_points", "resolution")})
    return (src, src_cov, src_mask), jvm, tvm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("seed,neighbors", [(0, 1), (1, 1), (0, 7), (1, 27)])
def test_vgicp_linearize_matches(seed, neighbors):
    """DIRECT1 / 7 / 27 correspondence search + linearization."""
    (src, cov, mask), jvm, tvm = _problem(seed)
    q = np.asarray(jm.quat_exp(jnp.asarray([0.004, 0.0, -0.01], jnp.float32)))
    t = np.array([0.05, 0.02, -0.01], np.float32)
    jH, jb, jc, jn, jcorr = jr.vgicp_linearize(jnp.asarray(src), jnp.asarray(cov),
                                               jnp.asarray(mask), jvm, jnp.asarray(q),
                                               jnp.asarray(t), 2.0, 16, neighbors=neighbors)
    T = lambda x: torch.from_numpy(np.array(x))
    tH, tb, tc, tn, tcorr = tr.vgicp_linearize(T(src), T(cov), T(mask), tvm, T(q), T(t), 2.0, 16,
                                               neighbors=neighbors)
    assert int(tn) == int(jn) > 500
    np.testing.assert_array_equal(tcorr.valid.numpy(), np.asarray(jcorr.valid))
    assert _rel(tH.numpy(), jH) < 1e-3
    assert _rel(tb.numpy(), jb) < 1e-3
    assert _rel(tc.numpy(), jc) < 1e-3
    jf, jnf = jr.vgicp_fitness(jnp.asarray(src), jnp.asarray(mask), jvm, jnp.asarray(q),
                               jnp.asarray(t), 2.0)
    tf, tnf = tr.vgicp_fitness(T(src), T(mask), tvm, T(q), T(t), 2.0)
    assert int(tnf) == int(jnf) and _rel(tf.numpy(), jf) < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_register_lambda_trace_matches(seed):
    (src, cov, mask), jvm, tvm = _problem(seed)
    q0 = np.array([1, 0, 0, 0], np.float32)
    t0 = np.zeros(3, np.float32)
    jres, jtr = jr.lm_register(jnp.asarray(src), jnp.asarray(cov), jnp.asarray(mask), jvm,
                               jnp.asarray(q0), jnp.asarray(t0), JCFG, with_trace=True)
    T = lambda x: torch.from_numpy(np.array(x))
    tres, ttr = tr.lm_register(T(src), T(cov), T(mask), tvm, T(q0), T(t0), TCFG,
                               with_trace=True)
    n = int(jtr["n_outer"])
    assert int(ttr["n_outer"]) == n and 2 <= n < JCFG.vgicp_max_iterations
    np.testing.assert_array_equal(ttr["accepted"].numpy(), np.asarray(jtr["accepted"]))
    np.testing.assert_array_equal(ttr["n_rejects"].numpy(), np.asarray(jtr["n_rejects"]))
    # λ after the last outer iteration comes from the gain ratio of two
    # nearly equal costs at convergence (rounding-dominated): gated on the
    # iterations before it
    assert _rel(ttr["lam_after"].numpy()[:n - 1], np.asarray(jtr["lam_after"])[:n - 1]) < 1e-3
    assert _rel(ttr["y0"].numpy()[:n], np.asarray(jtr["y0"])[:n]) < 1e-3
    np.testing.assert_allclose(tres.q.numpy(), np.asarray(jres.q), atol=1e-4)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-4)
    assert int(tres.n_corr) == int(jres.n_corr)
    assert abs(float(tres.fitness) - float(jres.fitness)) < 1e-4
    # and it recovered the applied motion
    np.testing.assert_allclose(tres.t.numpy(), [0.12, -0.08, 0.03], atol=0.02)
