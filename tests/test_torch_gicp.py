"""ops/gicp of the port (the loop-ICP part: kNN covariances and normals,
GICP and point-to-plane registration) against ``rgc_slam_tpu/ops/gicp.py``
on the same clouds: the loop-ICP oracle's structured submap (walls, floor,
a box) and a drifted, resampled copy of it.

Gates: covariances to 1e-5 absolute (plane-regularized, eigenvalues
1e-3/1/1); normals to 1e-4 up to sign where the smallest eigenvalue is
separated (a flat patch); registration poses to 1e-4, fitness to 1e-3
relative, the correspondence and iteration counts exactly.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.ops import gicp as jgicp
from rgc_slam_tpu.utils import math3d as jm3
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.ops import gicp as tgicp
from rgc_slam_tpu_torch.utils import math3d as tm3
from test_parity_oracles import _drifted, _submap_points

torch.set_num_threads(1)


def _clouds(n_tgt=1024, n_src=256, keep=0.9):
    g = np.random.default_rng(4)
    tgt = _submap_points(21, n_tgt).astype(np.float32)
    src = _drifted(_submap_points(21, n_src), 0.04, [0.25, -0.15, 0.03]).astype(np.float32)
    return src, g.random(n_src) < keep, tgt, g.random(n_tgt) < keep


@pytest.mark.parametrize("method", ["plane", "norm_min_eig"])
def test_knn_covariances_match(method):
    _, _, pts, mask = _clouds()
    j = np.asarray(jgicp.knn_covariances(jnp.asarray(pts), jnp.asarray(mask), 20, method))
    t = tgicp.knn_covariances(torch.from_numpy(pts), torch.from_numpy(mask), 20, method).numpy()
    assert t.shape == (len(pts), 3, 3)
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)


def test_plane_normals_match_up_to_sign():
    _, _, pts, mask = _clouds()
    j = np.asarray(jgicp.plane_normals(jnp.asarray(pts), jnp.asarray(mask), 20))
    t = tgicp.plane_normals(torch.from_numpy(pts), torch.from_numpy(mask), 20).numpy()
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-5)
    # compare where the patch is flat: the smallest eigenvalue is separated
    d = pts[:, None, :] - pts[None, mask, :]
    near = np.argsort((d * d).sum(-1), axis=1)[:, :20]
    nb = pts[mask][near]
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", nb - nb.mean(1, keepdims=True),
                                      nb - nb.mean(1, keepdims=True)))
    flat = ev[:, 0] < 0.1 * ev[:, 1]
    assert flat.sum() > 0.5 * len(pts)
    err = np.minimum(np.abs(t - j).max(1), np.abs(t + j).max(1))
    assert err[flat].max() < 1e-4, err[flat].max()


@pytest.mark.parametrize("register", ["gicp_register", "p2plane_register"])
def test_registration_matches(register):
    src, src_mask, tgt, tgt_mask = _clouds()
    cfg = dataclasses.replace(JCFG, vgicp_max_corr_dist=1.0)
    tcfg = dataclasses.replace(TCFG, vgicp_max_corr_dist=1.0)
    q0 = np.array([1.0, 0, 0, 0], np.float32)
    t0 = np.zeros(3, np.float32)
    jres = jax.jit(functools.partial(getattr(jgicp, register), cfg=cfg, max_iters=30))(
        jnp.asarray(src), jnp.asarray(src_mask), jnp.asarray(tgt), jnp.asarray(tgt_mask),
        jnp.asarray(q0), jnp.asarray(t0))
    tres = getattr(tgicp, register)(
        torch.from_numpy(src), torch.from_numpy(src_mask), torch.from_numpy(tgt),
        torch.from_numpy(tgt_mask), torch.from_numpy(q0), torch.from_numpy(t0), tcfg,
        max_iters=30)
    assert int(tres.iterations) == int(jres.iterations) and int(tres.iterations) > 1
    assert int(tres.n_corr) == int(jres.n_corr) > 100
    R_t, R_j = tm3.quat_to_mat(tres.q).numpy(), np.asarray(jm3.quat_to_mat(jres.q))
    assert np.abs(R_t - R_j).max() < 1e-4
    assert np.abs(tres.t.numpy() - np.asarray(jres.t)).max() < 1e-4
    assert abs(float(tres.fitness) - float(jres.fitness)) <= 1e-3 * float(jres.fitness)
    # the registration undid most of the 0.3 m drift
    assert np.abs(tres.t.numpy()).max() > 0.1
    np.testing.assert_allclose(tres.H.numpy(), np.asarray(jres.H), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jres.H)).max())
