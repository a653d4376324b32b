"""ops/gicp's GICP-MP and NDT registrations of the port, and the Cauchy
weights of ops/registration, against ``rgc_slam_tpu/ops`` on the same inputs:
the 2000-point ``cloud_pair`` of tests/test_gicp_variants.py (two walls and
the ground, 1 cm noise, the target the source moved by a known pose).

Gates: the pose within max(5e-3 m, 2 x JAX's own deviation when the inputs
are perturbed by 1e-7 relative; PERF.md §2's rule), the correspondence and
iteration counts exactly; the NDT voxel maps' keys, counts and published
mask exactly, means and covariances to rtol 1e-4 / atol 1e-5; the
robustified weights, costs and normal equations to 1e-5 relative; the
fitness to 1e-3 relative or (1 mm)².
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.ops import gicp as jgicp
from rgc_slam_tpu.ops import registration as jreg
from rgc_slam_tpu.utils import math3d as jm3
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.ops import gicp as tgicp
from rgc_slam_tpu_torch.ops import registration as treg
from rgc_slam_tpu_torch.utils import math3d as tm3
from test_gicp_variants import _structured_cloud

torch.set_num_threads(1)
POSE_FLOOR = 5e-3
Q0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
T0 = np.zeros(3, np.float32)


@pytest.fixture(scope="module")
def cloud_pair():
    """tests/test_gicp_variants.py's pair, drawn the same way."""
    rng = np.random.default_rng(42)
    src = _structured_cloud(rng)
    q_gt = np.asarray(jm3.ypr_to_quat(jnp.array([0.05, 0.02, -0.03])))
    t_gt = np.array([0.3, -0.2, 0.1], np.float32)
    tgt = np.asarray(jm3.quat_rotate(jnp.asarray(q_gt)[None], jnp.asarray(src))) + t_gt
    return src, tgt.astype(np.float32), q_gt, t_gt


def _perturbed(x, seed):
    g = np.random.default_rng(seed)
    return (x * (1 + 1e-7 * g.standard_normal(x.shape))).astype(np.float32)


def _pose(res):
    return np.asarray(jm3.quat_to_mat(jnp.asarray(res.q))), np.asarray(res.t)


def _pose_gap(a, b):
    return max(np.abs(a[0] - b[0]).max(), np.abs(a[1] - b[1]).max())


def _run_both(name, src, tgt, mask_src, mask_tgt, **kw):
    jfn, tfn = getattr(jgicp, name), getattr(tgicp, name)
    jres = jfn(jnp.asarray(src), jnp.asarray(mask_src), jnp.asarray(tgt), jnp.asarray(mask_tgt),
               jnp.asarray(Q0), jnp.asarray(T0), JCFG, **kw)
    tres = tfn(torch.from_numpy(src), torch.from_numpy(mask_src), torch.from_numpy(tgt),
               torch.from_numpy(mask_tgt), torch.from_numpy(Q0), torch.from_numpy(T0), TCFG, **kw)
    return jres, tres


def _gate(name, cloud_pair, t_truth, **kw):
    """The port against JAX on the pair, with the gate from JAX's own
    deviation over two perturbed runs; the port's result."""
    src, tgt, q_gt, t_gt = cloud_pair
    ones = np.ones(len(src), bool)
    jres, tres = _run_both(name, src, tgt, ones, ones, **kw)
    jfn = getattr(jgicp, name)
    env = max(_pose_gap(_pose(jfn(jnp.asarray(_perturbed(src, s)), jnp.asarray(ones),
                                  jnp.asarray(_perturbed(tgt, s + 10)), jnp.asarray(ones),
                                  jnp.asarray(Q0), jnp.asarray(T0), JCFG, **kw)), _pose(jres))
              for s in (1, 2))
    gate = max(POSE_FLOOR, 2 * env)
    R_t = tm3.quat_to_mat(tres.q).numpy()
    gap = _pose_gap((R_t, tres.t.numpy()), _pose(jres))
    assert gap <= gate, (name, kw, gap, gate)
    assert int(tres.iterations) == int(jres.iterations) > 0
    assert int(tres.n_corr) == int(jres.n_corr)
    assert tres.n_corr.dtype == torch.int32 and tres.iterations.dtype == torch.int32
    assert np.isfinite(tres.H.numpy()).all() and tres.H.shape == (6, 6)
    # the mean squared 1-NN distance: (1 mm)² apart at most, since the
    # mp pair's fitness is float32 roundoff of an exact match (~1e-6 m²)
    np.testing.assert_allclose(float(tres.fitness), float(jres.fitness), rtol=1e-3, atol=1e-6)
    # the JAX test's limits against the true motion
    assert np.abs(tres.t.numpy() - t_gt).max() < t_truth
    assert abs(float((tres.q * torch.from_numpy(q_gt.astype(np.float32))).sum())) > 0.9999
    return tres


def test_gicp_mp_register_matches(cloud_pair):
    tres = _gate("gicp_mp_register", cloud_pair, 0.03)
    assert int(tres.n_corr) > len(cloud_pair[0]) // 2


def test_gicp_mp_empty_overlap_matches(cloud_pair):
    """No target point within the radius: both stay put, no correspondence."""
    src, tgt, _, _ = cloud_pair
    ones = np.ones(len(src), bool)
    jres, tres = _run_both("gicp_mp_register", src, tgt + np.float32(100.0), ones, ones,
                           max_iters=4)
    assert int(tres.n_corr) == int(jres.n_corr) == 0
    assert int(tres.iterations) == int(jres.iterations)
    assert np.isfinite(tres.t.numpy()).all() and np.abs(tres.t.numpy()).max() < 1e-3
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-6)


@pytest.mark.parametrize("mode", ["d2d", "p2d"])
def test_ndt_register_matches(cloud_pair, mode):
    tres = _gate("ndt_register", cloud_pair, 0.1, resolution=1.0, distance_mode=mode)
    assert int(tres.n_corr) > (50 if mode == "d2d" else 500)


def test_ndt_unknown_mode_raises(cloud_pair):
    src, tgt, _, _ = cloud_pair
    ones = torch.ones(len(src), dtype=torch.bool)
    with pytest.raises(ValueError, match="distance_mode"):
        tgicp.ndt_register(torch.from_numpy(src), ones, torch.from_numpy(tgt), ones,
                           torch.from_numpy(Q0), torch.from_numpy(T0), TCFG,
                           distance_mode="d2p")


@pytest.mark.parametrize("min_points", [1, 7])
def test_build_ndt_voxelmap_matches(cloud_pair, min_points):
    src, _, _, _ = cloud_pair
    mask = np.random.default_rng(3).random(len(src)) < 0.9
    j = jgicp.build_ndt_voxelmap(jnp.asarray(src), jnp.asarray(mask), 1.0, JCFG.max_voxels,
                                 probes=JCFG.hash_probes, min_points=min_points)
    t = tgicp.build_ndt_voxelmap(torch.from_numpy(src), torch.from_numpy(mask), 1.0,
                                 TCFG.max_voxels, probes=TCFG.hash_probes, min_points=min_points)
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(t.num_points.numpy(), np.asarray(j.num_points))
    published = t.num_points.numpy() > 0
    assert 20 < published.sum() < len(published)
    np.testing.assert_allclose(t.mean.numpy(), np.asarray(j.mean), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.cov.numpy(), np.asarray(j.cov), rtol=1e-4, atol=1e-5)
    assert float(t.resolution) == float(j.resolution)
    # empty slots hold identity covariances
    np.testing.assert_array_equal(t.cov.numpy()[~published], np.broadcast_to(
        np.eye(3, dtype=np.float32), (int((~published).sum()), 3, 3)))


def _correspondences(rng, n=300):
    src = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    mean_B = (src + rng.normal(0, 0.4, (n, 3))).astype(np.float32)
    A = rng.normal(0, 0.3, (n, 3, 3)).astype(np.float32)
    Minv = (np.einsum("nij,nkj->nik", A, A) + 0.1 * np.eye(3, dtype=np.float32)).astype(np.float32)
    valid = rng.random(n) < 0.8
    w = np.where(valid, rng.uniform(1, 3, n), 0).astype(np.float32)
    q = np.array(jm3.ypr_to_quat(jnp.asarray([0.02, -0.01, 0.015])))
    t = np.array([0.1, 0.05, -0.08], np.float32)
    return src, (mean_B, Minv, w, valid), q, t


@pytest.mark.parametrize("cauchy_k", [None, 0.5, 1.0])
def test_cauchy_weights_match(rng, cauchy_k):
    """``_robust_w`` and the cost / normal equations built with it."""
    src, fields, q, t = _correspondences(rng)
    jc = jreg.Correspondences(*(jnp.asarray(f) for f in fields))
    tc = treg.Correspondences(*(torch.from_numpy(f) for f in fields))
    err = rng.normal(0, 0.5, (len(src), 3)).astype(np.float32)
    np.testing.assert_allclose(
        treg._robust_w(tc.w, torch.from_numpy(err), cauchy_k).numpy(),
        np.asarray(jreg._robust_w(jc.w, jnp.asarray(err), cauchy_k)), rtol=1e-6, atol=0)
    T, J = torch.from_numpy, jnp.asarray
    cost_t = treg.corr_cost(tc, T(src), T(q), T(t), cauchy_k=cauchy_k)
    cost_j = jreg.corr_cost(jc, J(src), J(q), J(t), cauchy_k=cauchy_k)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-5)
    H_t, b_t, c_t = treg.corr_linearize(tc, T(src), T(q), T(t), cauchy_k=cauchy_k)
    H_j, b_j, c_j = jreg.corr_linearize(jc, J(src), J(q), J(t), cauchy_k=cauchy_k)
    for a, b in ((H_t, H_j), (b_t, b_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-5)
    if cauchy_k is not None:      # the weights do change the sums
        plain = treg.corr_cost(tc, T(src), T(q), T(t))
        assert float(cost_t) < 0.99 * float(plain)


def test_lm_drive_with_cauchy_matches(cloud_pair):
    """``registration.lm_drive`` with ``cauchy_k`` over the NDT p2d
    correspondences of a looser config: the same steps as JAX's LM loop."""
    src, tgt, _, _ = cloud_pair
    ones = np.ones(len(src), bool)
    jcfg = dataclasses.replace(JCFG, lm_max_inner=3)
    tcfg = dataclasses.replace(TCFG, lm_max_inner=3)
    jres = jgicp.ndt_register(jnp.asarray(src), jnp.asarray(ones), jnp.asarray(tgt),
                              jnp.asarray(ones), jnp.asarray(Q0), jnp.asarray(T0), jcfg,
                              resolution=0.5, max_iters=6, distance_mode="p2d")
    tres = tgicp.ndt_register(torch.from_numpy(src), torch.from_numpy(ones), torch.from_numpy(tgt),
                              torch.from_numpy(ones), torch.from_numpy(Q0), torch.from_numpy(T0),
                              tcfg, resolution=0.5, max_iters=6, distance_mode="p2d")
    assert int(tres.iterations) == int(jres.iterations)
    assert int(tres.n_corr) == int(jres.n_corr)
    R_t = tm3.quat_to_mat(tres.q).numpy()
    assert _pose_gap((R_t, tres.t.numpy()), _pose(jres)) < 1e-4


def test_gicp_mp_under_vmap(cloud_pair):
    """Two lanes (the pair, and the target moved out of reach) through one
    ``torch.func.vmap`` with the per-lane fallback off: each lane as its
    own call, the finished lane keeping its pose."""
    from rgc_slam_tpu_torch.utils.lanes import strict_vmap

    src, tgt, _, _ = cloud_pair
    src, tgt = torch.from_numpy(src[::3].copy()), torch.from_numpy(tgt[::3].copy())
    ones = torch.ones(len(src), dtype=torch.bool)
    q0, t0 = torch.from_numpy(Q0), torch.from_numpy(T0)
    targets = torch.stack([tgt, tgt + 100.0])
    with strict_vmap():
        lanes = torch.func.vmap(lambda tg: tgicp.gicp_mp_register(src, ones, tg, ones, q0, t0,
                                                                  TCFG))(targets)
    for b in range(2):
        one = tgicp.gicp_mp_register(src, ones, targets[b], ones, q0, t0, TCFG)
        assert int(lanes.iterations[b]) == int(one.iterations)
        assert int(lanes.n_corr[b]) == int(one.n_corr)
        np.testing.assert_allclose(lanes.t[b].numpy(), one.t.numpy(), atol=1e-5)
    assert int(lanes.iterations[0]) > int(lanes.iterations[1]) == 1
