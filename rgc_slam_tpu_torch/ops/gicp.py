"""Point-correspondence GICP and NDT registration: the port of
``rgc_slam_tpu/ops/gicp.py``.

  * ``gicp_register``: FastGICP, per-point 1-NN correspondences with the
    distribution-to-distribution Mahalanobis cost, covariances from the
    k=20 nearest neighbours of each cloud;
  * ``p2plane_register``: the same LM loop with ``Minv = n nᵀ`` from
    target normals (``plane_normals``);
  * ``gicp_mp_register``: FastGICPMultiPoints, each source point fused
    with its ``fuse_k`` nearest target points within a radius, plain
    Gauss-Newton;
  * ``ndt_register``: NDTCuda in its d2d and p2d modes over the voxel
    Gaussians of ``build_ndt_voxelmap``, with the pose-dependent Cauchy
    weights (``registration._robust_w``).

GICP, point-to-plane and NDT run ``registration.lm_drive``, the
LsqRegistration LM loop with frozen correspondences that ``lm_register``
runs too; its early exits, and ``gicp_mp_register``'s, are Python loops
reading the stop flags on the host through ``utils.lanes.any_lane``.  Every
kNN goes through ``ops/knn.knn``, the Hopper kernel on CUDA.
"""
from __future__ import annotations

import torch

from ..config import SlamConfig
from ..types import VoxelMap
from ..utils import math3d as m3
from ..utils.lanes import any_lane
from . import knn as knn_ops
from . import voxelhash as vh
from .covariance import eigh3x3, regularize_covariances
from .registration import (
    Correspondences,
    RegistrationResult,
    _inv3_sym,
    _transform,
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


def _lm_drive(corr_fn, src, q0, t0, cfg: SlamConfig, max_iters: int, cauchy_k=None):
    """``registration.lm_drive``, then the correspondences at the final
    pose: (q, t, cost, n_corr, iterations, H) there, as the JAX driver
    returns them.  ``cauchy_k`` (NDT) robustifies the linearization and the
    accept-test cost (``registration._robust_w``)."""
    q, t, _, it, _, _, _ = lm_drive(corr_fn, src, q0, t0, cfg, max_iters, cauchy_k=cauchy_k)
    corr = corr_fn(q, t)
    H, _, cost = corr_linearize(corr, src, q, t, cauchy_k=cauchy_k)
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


def gicp_mp_register(src, src_mask, tgt, tgt_mask, q0, t0, cfg: SlamConfig, knn_k: int = 20,
                     radius: float = 0.5, fuse_k: int = 16,
                     max_iters: int = 64) -> RegistrationResult:
    """FastGICPMultiPoints (experimental/fast_gicp_mp_impl.hpp).

    Each source point fuses its ``fuse_k`` nearest target points within
    ``radius`` into one Gaussian, weights ``clip(1 - d/r, 1e-3, 1)``; plain
    Gauss-Newton on the whitened residual ``M⁻¹ (mean_B - T mean_A)``, the
    correspondences searched again every iteration, with the reference's
    update ``R <- exp(-dr) R``, ``t <- t - dt`` and the shared convergence
    test on the step.  The loop runs while a lane runs (``any_lane``); a
    finished lane keeps its pose."""
    src_cov = knn_covariances(src, src_mask, knn_k)
    tgt_cov = knn_covariances(tgt, tgt_mask, knn_k)
    dtype, dev = src.dtype, src.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    r2 = torch.tensor(radius * radius, dtype=dtype, device=dev)

    def linearize(q, t):
        Tp = _transform(q, t, src)
        d2, idx = knn_ops.knn(Tp, tgt, tgt_mask, fuse_k)           # [N, k]
        idx = idx.long()
        ok = src_mask[:, None] & torch.isfinite(d2) & (d2 <= r2)
        w = torch.clamp(1.0 - torch.sqrt(torch.clamp(d2, min=0.0)) / radius, 1e-3, 1.0)
        w = torch.where(ok, w, torch.zeros_like(w))
        wsum = w.sum(1)
        has = wsum > 0                                             # the reference skips empty
        denom = torch.clamp(wsum, min=1e-6)
        mean_B = torch.einsum("nk,nki->ni", w, tgt[idx]) / denom[:, None]
        cov_B = torch.einsum("nk,nkij->nij", w, tgt_cov[idx]) / denom[:, None, None]
        R = m3.quat_to_mat(q)
        Minv = _inv3_sym(cov_B + torch.einsum("ij,njk,lk->nil", R, src_cov, R))
        r = torch.einsum("nij,nj->ni", Minv, mean_B - Tp)           # M⁻¹ d
        J = torch.cat([torch.einsum("nij,njk->nik", Minv, m3.skew(Tp)), -Minv], -1)   # [N, 3, 6]
        wm = has.to(dtype)
        H = torch.einsum("n,nri,nrj->ij", wm, J, J)
        b = torch.einsum("n,nri,nr->i", wm, J, r)
        return H, b, has.sum().to(torch.int32)

    def is_converged(delta):
        dR = m3.quat_to_mat(m3.quat_exp(delta[:3])) - eye3
        return torch.maximum(torch.abs(dR).max() / cfg.rotation_epsilon,
                             torch.abs(delta[3:]).max() / cfg.translation_epsilon) < 1.0

    q, t = q0.to(dtype), t0.to(dtype)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        H, b, _ = linearize(q, t)
        delta = torch.linalg.solve_ex(H + 1e-9 * eye6, b)[0]
        q = torch.where(active, m3.quat_normalize(m3.quat_mul(m3.quat_exp(-delta[:3]), q)), q)
        t = torch.where(active, t - delta[3:], t)
        it = it + active.to(torch.int32)
        active = active & ~is_converged(delta)
        if not bool(any_lane(active)):
            break
    H, _, n = linearize(q, t)
    fit = _fitness(src, src_mask, tgt, tgt_mask, q, t, radius)
    return RegistrationResult(q=q, t=t, fitness=fit, n_corr=n, iterations=it, H=H)


def build_ndt_voxelmap(pts, mask, resolution: float, cap: int, min_eig_ratio: float = 0.01,
                       probes: int = 16, min_points: int = 5) -> VoxelMap:
    """NDT voxel map: per-voxel mean and positional covariance (two-pass,
    centred on the voxel's mean), its eigenvalues floored at
    ``min_eig_ratio`` of the largest (cuda/covariance_regularization.cu);
    GaussianVoxelMap's half-shifted binning, so ``voxelmap_lookup`` finds
    the bins.  Only voxels with at least ``min_points`` points publish
    (the target's gate is num_points > 6; source voxels of d2d count from
    one); the rest are empty, with identity covariances.  The segment sums
    add in float64 (``voxelhash.segment_sum``)."""
    dtype = pts.dtype
    eye = torch.eye(3, dtype=dtype, device=pts.device)
    keys = vh.pack_coords(vh.voxel_coords(pts, resolution, offset=0.5), mask)
    ht = vh.build_hash_table(keys, cap, probes)
    slot = torch.where(ht.slot_of_point >= 0, ht.slot_of_point,
                       torch.full_like(ht.slot_of_point, cap)).long()
    w = (slot < cap).to(dtype)
    counts = vh.segment_sum(w, slot, cap + 1)[:cap]
    denom = torch.clamp(counts, min=1.0)[:, None]
    mean = vh.segment_sum(pts * w[:, None], slot, cap + 1)[:cap] / denom
    centered = pts - mean[torch.clamp(slot, 0, cap - 1)]
    cov = vh.segment_sum(torch.einsum("ni,nj->nij", centered, centered) * w[:, None, None],
                         slot, cap + 1)[:cap] / denom[..., None]
    evals, evecs = eigh3x3(cov + 1e-9 * eye)
    evals = torch.maximum(evals, min_eig_ratio * evals[..., 2:3])
    cov = torch.einsum("...ik,...k,...jk->...ij", evecs, evals, evecs)
    ok = counts >= min_points
    return VoxelMap(
        keys=torch.where(ok, ht.table_keys, torch.full_like(ht.table_keys, vh.EMPTY)),
        mean=torch.where(ok[:, None], mean, torch.zeros_like(mean)),
        cov=torch.where(ok[:, None, None], cov, eye),
        num_points=torch.where(ok, counts, torch.zeros_like(counts)),
        resolution=torch.tensor(resolution, dtype=dtype, device=pts.device),
    )


def ndt_register(src, src_mask, tgt, tgt_mask, q0, t0, cfg: SlamConfig, resolution: float = 1.0,
                 max_iters: int = 30, distance_mode: str = "d2d") -> RegistrationResult:
    """NDTCuda, both NDTDistanceMode variants (ndt_cuda.cu):

      * "d2d": the source's voxel Gaussians against the target's,
        Mahalanobis (cov_B + R cov_A Rᵀ)⁻¹ with R at the linearization
        pose; source voxels of any count;
      * "p2d": the source points against the target's voxel Gaussians,
        cov_B⁻¹ alone.

    Both take target voxels of more than 6 points and weigh each term by
    the Cauchy weight with k = ``resolution`` at every evaluation pose.
    Another ``distance_mode`` raises ``ValueError``."""
    if distance_mode not in ("d2d", "p2d"):
        raise ValueError(f"unknown NDT distance_mode {distance_mode!r}")
    vm = build_ndt_voxelmap(tgt, tgt_mask, resolution, cfg.max_voxels, probes=cfg.hash_probes,
                            min_points=7)
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    if distance_mode == "d2d":
        svm = build_ndt_voxelmap(src, src_mask, resolution, cfg.max_voxels,
                                 probes=cfg.hash_probes, min_points=1)
        means, covs, mmask = svm.mean, svm.cov, svm.num_points > 0
    else:
        means, covs, mmask = src, None, src_mask

    def corr_fn(q, t):
        slots = vh.voxelmap_lookup(vm, _transform(q, t, means), cfg.hash_probes)
        sl = torch.clamp(slots, 0, vm.mean.shape[0] - 1).long()
        valid = (slots >= 0) & mmask & (vm.num_points[sl] > 6)
        C = vm.cov[sl]
        if covs is not None:
            R = m3.quat_to_mat(q)
            C = C + torch.einsum("ij,njk,lk->nil", R, covs, R)
        return Correspondences(mean_B=vm.mean[sl], Minv=_inv3_sym(C + 1e-9 * eye),
                               w=valid.to(src.dtype), valid=valid)

    q, t, cost, n, it, H = _lm_drive(corr_fn, means, q0, t0, cfg, max_iters, cauchy_k=resolution)
    return RegistrationResult(q=q, t=t, fitness=cost / torch.clamp(n, min=1), n_corr=n,
                              iterations=it, H=H)
