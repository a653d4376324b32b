"""Point-correspondence GICP and point-to-plane ICP: the port of the part
of ``rgc_slam_tpu/ops/gicp.py`` that loop closure reaches
(``cfg.loop_icp_method`` "gicp" and "plane").

  * ``gicp_register``: FastGICP, per-point 1-NN correspondences with the
    distribution-to-distribution Mahalanobis cost, covariances from the
    k=20 nearest neighbours of each cloud;
  * ``p2plane_register``: the same LM loop with ``Minv = n nᵀ`` from
    target normals (``plane_normals``).

Both run ``registration.lm_drive``, the LsqRegistration LM loop with
frozen correspondences that ``lm_register`` runs too, whose early exits
are Python loops reading the stop flags on the host.  Every kNN goes through
``ops/knn.knn``, the Hopper kernel on CUDA.  The NDT variants and
``gicp_mp_register`` are not ported: no engine code calls them.
"""
from __future__ import annotations

import torch

from ..config import SlamConfig
from ..utils import math3d as m3
from . import knn as knn_ops
from .covariance import eigh3x3, regularize_covariances
from .registration import (
    Correspondences,
    RegistrationResult,
    _inv3_sym,
    corr_linearize,
    lm_drive,
)


def _knn_moments(pts, mask, k: int):
    """Covariance of each point's k nearest unmasked neighbours (two-pass,
    weights 0 for masked or missing neighbours)."""
    d2, idx = knn_ops.knn(pts, pts, mask, k)
    idx = idx.long()
    near = pts[idx]                                    # [N, k, 3]
    w = (mask[idx] & torch.isfinite(d2)).to(pts.dtype)
    wsum = torch.clamp(w.sum(1), min=1.0)
    mean = (near * w[..., None]).sum(1) / wsum[:, None]
    d = (near - mean[:, None, :]) * w[..., None]
    return torch.einsum("nki,nkj->nij", d, d) / wsum[:, None, None]


def knn_covariances(pts, mask, k: int = 20, method: str = "plane"):
    """Per-point regularized covariance from the k nearest neighbours
    (``FastGICP::calculate_covariances``); ``method`` is the
    RegularizationMethod."""
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    return regularize_covariances(_knn_moments(pts, mask, k) + 1e-6 * eye, method)


def _gicp_correspondences(src, src_cov, src_mask, tgt, tgt_cov, tgt_mask, q, t,
                          max_corr) -> Correspondences:
    """1-NN correspondence + Mahalanobis (C_B + R C_A Rᵀ)⁻¹ at pose (q, t)."""
    Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
    d2, idx = knn_ops.knn(Tp, tgt, tgt_mask, 1)
    j = idx[:, 0].long()
    valid = src_mask & (d2[:, 0] < max_corr * max_corr)
    R = m3.quat_to_mat(q)
    RCA = torch.einsum("ij,njk,lk->nil", R, src_cov, R)
    return Correspondences(mean_B=tgt[j], Minv=_inv3_sym(tgt_cov[j] + RCA),
                           w=valid.to(src.dtype), valid=valid)


def _lm_drive(corr_fn, src, q0, t0, cfg: SlamConfig, max_iters: int):
    """``registration.lm_drive``, then the correspondences at the final
    pose: (q, t, cost, n_corr, iterations, H) there, as the JAX driver
    returns them."""
    q, t, _, it, _ = lm_drive(corr_fn, src, q0, t0, cfg, max_iters)
    corr = corr_fn(q, t)
    H, _, cost = corr_linearize(corr, src, q, t)
    return q, t, cost, corr.valid.sum().to(torch.int32), it, H


def _fitness(src, src_mask, tgt, tgt_mask, q, t, max_corr):
    """Mean squared 1-NN distance over the matched source points."""
    Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
    d2, _ = knn_ops.knn(Tp, tgt, tgt_mask, 1)
    match = src_mask & (d2[:, 0] < max_corr * max_corr)
    return torch.where(match, d2[:, 0], torch.zeros_like(d2[:, 0])).sum() / torch.clamp(
        match.sum(), min=1)


def gicp_register(src, src_mask, tgt, tgt_mask, q0, t0, cfg: SlamConfig, knn_k: int = 20,
                  max_iters: int = 64) -> RegistrationResult:
    """FastGICP: per-point D2D with kNN covariances on both clouds."""
    src_cov = knn_covariances(src, src_mask, knn_k)
    tgt_cov = knn_covariances(tgt, tgt_mask, knn_k)
    max_corr = cfg.vgicp_max_corr_dist

    def corr_fn(q, t):
        return _gicp_correspondences(src, src_cov, src_mask, tgt, tgt_cov, tgt_mask, q, t,
                                     max_corr)

    q, t, _, n, it, H = _lm_drive(corr_fn, src, q0, t0, cfg, max_iters)
    fit = _fitness(src, src_mask, tgt, tgt_mask, q, t, max_corr)
    return RegistrationResult(q=q, t=t, fitness=fit, n_corr=n, iterations=it, H=H)


def plane_normals(pts, mask, k: int = 20):
    """Per-point unit normals: the smallest-eigenvalue direction of the
    k-NN covariance (the sign is the eigen solver's)."""
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    _, V = eigh3x3(_knn_moments(pts, mask, k) + 1e-9 * eye)
    return V[..., 0]


def p2plane_register(src, src_mask, tgt, tgt_mask, q0, t0, cfg: SlamConfig, knn_k: int = 20,
                     max_iters: int = 64) -> RegistrationResult:
    """Point-to-plane ICP through the same LM loop: ``Minv = n nᵀ`` makes
    the Mahalanobis cost w·(nᵀ(μ - Tp))²."""
    nrm = plane_normals(tgt, tgt_mask, knn_k)
    max_corr = cfg.vgicp_max_corr_dist

    def corr_fn(q, t):
        Tp = m3.quat_rotate(q[None, :], src) + t[None, :]
        d2, idx = knn_ops.knn(Tp, tgt, tgt_mask, 1)
        j = idx[:, 0].long()
        valid = src_mask & (d2[:, 0] < max_corr * max_corr)
        n = nrm[j]
        return Correspondences(mean_B=tgt[j], Minv=n[:, :, None] * n[:, None, :],
                               w=valid.to(src.dtype), valid=valid)

    q, t, _, n, it, H = _lm_drive(corr_fn, src, q0, t0, cfg, max_iters)
    fit = _fitness(src, src_mask, tgt, tgt_mask, q, t, max_corr)
    return RegistrationResult(q=q, t=t, fitness=fit, n_corr=n, iterations=it, H=H)
