"""VGICP scan-to-submap registration: the port of
``rgc_slam_tpu/ops/registration.py``.

``lm_drive`` keeps the reference's λ schedule (ρ gain ratio, ν doubling),
so3 retraction and rotation/translation convergence tests; ``lm_register``
(VGICP) and ``ops/gicp``'s GICP, point-to-plane ICP and NDT all run it (NDT
with the pose-dependent Cauchy weights of ``_robust_w``, ``cauchy_k``).  The
JAX package's nested ``lax.while_loop``s with early exit become Python loops
that read the stop flags back to the host once per iteration (through
``utils.lanes.any_lane``, so they keep ``jax.vmap``'s semantics under
``torch.func.vmap``); the per-outer-iteration λ trace is kept, so the
λ-schedule parity gate applies to the port unchanged.  Correspondences stay frozen between linearization
and the LM accept test (reference semantics).  With ``psum_axis`` (the sp
axis of a sharded step, ``utils/axes``) each rank linearizes its
block of the source and the 6x6 H, b and costs are summed over the axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..utils.axes import psum
from ..types import VoxelMap
from ..utils import math3d as m3
from ..utils.lanes import any_lane
from . import voxelhash as vh


class RegistrationResult(NamedTuple):
    q: torch.Tensor           # [4] target <- source
    t: torch.Tensor           # [3]
    fitness: torch.Tensor     # [] mean squared correspondence error
    n_corr: torch.Tensor      # [] correspondences at the solution
    iterations: torch.Tensor  # [] outer LM iterations
    H: torch.Tensor           # [6, 6] final Hessian


def _solve6(H: torch.Tensor, b: torch.Tensor, damping) -> torch.Tensor:
    """Solve (H + damping I) d = -b by Cholesky; zero step if not PD."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(H + damping * eye + 1e-8 * eye)
    ok = (info == 0) & torch.isfinite(L).all()
    L = torch.where(ok, L, eye)
    d = torch.cholesky_solve(-b[:, None], L)[:, 0]
    return torch.where(ok, d, torch.zeros_like(d))


def _inv3_sym(A: torch.Tensor) -> torch.Tensor:
    """Batched symmetric 3x3 inverse via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e = A[..., 1, 1], A[..., 1, 2]
    f = A[..., 2, 2]
    A11 = d * f - e * e
    A12 = c * e - b * f
    A13 = b * e - c * d
    A22 = a * f - c * c
    A23 = b * c - a * e
    A33 = a * d - b * b
    det = a * A11 + b * A12 + c * A13
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    M = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A12, A22, A23], -1),
        torch.stack([A13, A23, A33], -1),
    ], -2)
    return M * inv_det[..., None, None]


class Correspondences(NamedTuple):
    """Frozen correspondence set from one linearization point."""

    mean_B: torch.Tensor      # [N, 3]
    Minv: torch.Tensor        # [N, 3, 3]
    w: torch.Tensor           # [N] sqrt(voxel count), 0 where invalid
    valid: torch.Tensor       # [N]


NEIGHBOR_OFFSETS = {
    1: [(0, 0, 0)],
    7: [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
    27: [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
}


def _transform(q, t, src):
    return m3.quat_rotate(q[None, :], src) + t[None, :]


def find_correspondences(src, src_cov, src_mask, vm: VoxelMap, q, t, max_corr_dist: float,
                         probes: int = 16, neighbors: int = 1) -> Correspondences:
    """Voxel lookup (DIRECT1/7/27) + Mahalanobis precompute at pose (q, t)."""
    Tp = _transform(q, t, src)
    offsets = torch.tensor(NEIGHBOR_OFFSETS[neighbors], dtype=torch.int32, device=src.device)
    kk = offsets.shape[0]
    coords = vh.voxel_coords(Tp, vm.resolution, offset=0.5)
    nb = coords[:, None, :] + offsets[None, :, :]
    keys = vh.pack_coords(nb, src_mask[:, None])
    slots = vh.lookup_slots(vm.keys, keys.reshape(-1), probes)
    found = (slots >= 0) & torch.repeat_interleave(src_mask, kk)
    sl = torch.clamp(slots, 0, vm.mean.shape[0] - 1).long()
    Tp_r = torch.repeat_interleave(Tp, kk, 0)
    cov_r = torch.repeat_interleave(src_cov, kk, 0)
    mean_B = vm.mean[sl]
    err = mean_B - Tp_r
    valid = found & ((err * err).sum(-1) < max_corr_dist * max_corr_dist)
    w = torch.where(valid, torch.sqrt(torch.clamp(vm.num_points[sl], min=1.0)),
                    torch.zeros_like(err[:, 0]))
    R = m3.quat_to_mat(q)
    RCA = torch.einsum("ij,njk,lk->nil", R, cov_r, R)
    return Correspondences(mean_B=mean_B, Minv=_inv3_sym(vm.cov[sl] + RCA), w=w, valid=valid)


def _expand_src(src, corr: Correspondences):
    k = corr.mean_B.shape[0] // src.shape[0]
    return src if k == 1 else torch.repeat_interleave(src, k, 0)


def _robust_w(w, err, cauchy_k):
    """The NDT kernels' Cauchy robustifier (ndt_compute_derivatives.cu):
    w·k²/(k² + |err|²) with k the voxel resolution, recomputed at every
    evaluation pose, not frozen with the correspondences.  ``None``: the
    plain (VGICP / GICP) weights."""
    if cauchy_k is None:
        return w
    k2 = torch.tensor(cauchy_k * cauchy_k, dtype=err.dtype, device=err.device)
    return w * k2 / (k2 + (err * err).sum(-1))


def corr_cost(corr: Correspondences, src, q, t, psum_axis=None, cauchy_k=None):
    """Cost at (q, t) with frozen correspondences; ``cauchy_k`` robustifies
    each term by ``_robust_w``."""
    err = corr.mean_B - _transform(q, t, _expand_src(src, corr))
    Me = torch.einsum("nij,nj->ni", corr.Minv, err)
    cost = (_robust_w(corr.w, err, cauchy_k) * (err * Me).sum(-1)).sum()
    return psum(cost, psum_axis) if psum_axis is not None else cost


def corr_linearize(corr: Correspondences, src, q, t, psum_axis=None, cauchy_k=None):
    """H/b/cost at (q, t) with frozen correspondences; J = [skew(Tp) | -I].
    With ``psum_axis`` the rank's partial sums are summed over the axis (the
    reference's OpenMP per-thread H/b partials, fast_vgicp_impl.hpp);
    ``cauchy_k`` robustifies the weights by ``_robust_w`` at (q, t)."""
    Tp = _transform(q, t, _expand_src(src, corr))
    err = corr.mean_B - Tp
    w, Minv = _robust_w(corr.w, err, cauchy_k), corr.Minv
    Me = torch.einsum("nij,nj->ni", Minv, err)
    cost = (w * (err * Me).sum(-1)).sum()
    S = m3.skew(Tp)
    StM = torch.einsum("nji,njk->nik", S, Minv)
    b = torch.cat([
        (w[:, None] * torch.einsum("nik,nk->ni", StM, err)).sum(0),
        (w[:, None] * (-Me)).sum(0),
    ])
    H_rr = torch.einsum("n,nik,nkj->ij", w, StM, S)
    H_rt = -(w[:, None, None] * StM).sum(0)
    H_tt = torch.einsum("n,nij->ij", w, Minv)
    H = torch.cat([torch.cat([H_rr, H_rt], 1), torch.cat([H_rt.T, H_tt], 1)], 0)
    if psum_axis is not None:
        H, b, cost = psum(H, psum_axis), psum(b, psum_axis), psum(cost, psum_axis)
    return H, b, cost


def vgicp_linearize(src, src_cov, src_mask, vm, q, t, max_corr_dist, probes: int = 16,
                    psum_axis=None, neighbors: int = 1):
    """Correspondence search + linearization at (q, t).
    Returns (H, b, cost, n_corr, corr)."""
    corr = find_correspondences(src, src_cov, src_mask, vm, q, t, max_corr_dist, probes,
                                neighbors)
    H, b, cost = corr_linearize(corr, src, q, t, psum_axis)
    n = corr.valid.sum()
    return H, b, cost, (psum(n, psum_axis) if psum_axis is not None else n), corr


def vgicp_fitness(src, src_mask, vm, q, t, max_corr_dist, probes: int = 16, psum_axis=None):
    """Mean squared euclidean distance over matched points."""
    Tp = _transform(q, t, src)
    slots = vh.voxelmap_lookup(vm, Tp, probes)
    found = (slots >= 0) & src_mask
    err = vm.mean[torch.clamp(slots, 0, vm.mean.shape[0] - 1).long()] - Tp
    dist2 = (err * err).sum(-1)
    valid = found & (dist2 < max_corr_dist * max_corr_dist)
    n = valid.sum()
    tot = torch.where(valid, dist2, torch.zeros_like(dist2)).sum()
    if psum_axis is not None:
        n, tot = psum(n, psum_axis), psum(tot, psum_axis)
    return tot / torch.clamp(n, min=1), n


def lm_drive(corr_fn, src, q0, t0, cfg: SlamConfig, max_iters: int, with_trace: bool = False,
             psum_axis=None, cauchy_k=None):
    """The LsqRegistration LM loop over any frozen-correspondence function
    ``corr_fn(q, t) -> Correspondences``: λ from the gain ratio ρ, ν
    doubling, so3 retraction, rotation/translation convergence; with
    ``psum_axis`` the linearization and the trial costs are summed over
    the axis, so every rank takes the same steps; with ``cauchy_k`` (NDT)
    both use the pose-dependent Cauchy weights of ``_robust_w``.  Returns
    (q, t, H of the last linearization, outer iterations, trace); with
    ``with_trace`` the trace holds per outer iteration (y0, λ after the
    inner loop, rejects, accepted) padded to ``max_iters``, else it is
    None.

    Both loops stop on the host as soon as no lane is active
    (``utils.lanes.any_lane``): one stream stops at its own early exit,
    and under ``torch.func.vmap`` the loops run while any lane runs, a
    finished lane keeping its carry by ``torch.where``, which is what
    ``jax.vmap`` makes of the JAX package's nested ``lax.while_loop``s."""
    dtype, dev = src.dtype, src.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def is_converged(dq, dt_):
        r_ok = torch.abs(m3.quat_to_mat(dq) - eye3).max() / cfg.rotation_epsilon
        t_ok = torch.abs(dt_).max() / cfg.translation_epsilon
        return torch.maximum(r_ok, t_ok) < 1.0

    q, t = q0.to(dtype), t0.to(dtype)
    lm_lambda = torch.tensor(-1.0, dtype=dtype, device=dev)
    H = torch.zeros((6, 6), dtype=dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    trace = None
    if with_trace:
        trace = {"y0": torch.full((max_iters,), torch.nan, dtype=dtype, device=dev),
                 "lam_after": torch.full((max_iters,), torch.nan, dtype=dtype, device=dev),
                 "n_rejects": torch.zeros((max_iters,), dtype=torch.int32, device=dev),
                 "accepted": torch.zeros((max_iters,), dtype=torch.bool, device=dev)}
        slots = torch.arange(max_iters, device=dev)
    for outer in range(max_iters):
        corr = corr_fn(q, t)
        H_lin, b, y0 = corr_linearize(corr, src, q, t, psum_axis, cauchy_k)
        lam = torch.where(lm_lambda < 0,
                          cfg.lm_init_lambda_factor * torch.abs(torch.diagonal(H_lin)).max(),
                          lm_lambda)
        nu = torch.tensor(2.0, dtype=dtype, device=dev)
        q_out, t_out = q, t
        conv = torch.tensor(False, device=dev)
        accepted = torch.tensor(False, device=dev)
        trying = active                  # lanes still in this inner loop
        k = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(cfg.lm_max_inner):
            d = _solve6(H_lin, b, lam)
            dq = m3.quat_exp(d[:3])
            dt_ = d[3:]
            q_new = m3.quat_normalize(m3.quat_mul(dq, q))
            t_new = m3.quat_rotate(dq, t) + dt_
            yi = corr_cost(corr, src, q_new, t_new, psum_axis, cauchy_k)
            denom = torch.dot(d, lam * d - b)
            rho = (y0 - yi) / torch.where(torch.abs(denom) < 1e-12,
                                          torch.full_like(denom, 1e-12), denom)
            accept = rho > 0
            conv_now = is_converged(dq, dt_)
            lam = torch.where(trying, torch.where(
                accept, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                nu * lam), lam)
            nu = torch.where(trying, torch.where(accept, torch.full_like(nu, 2.0), 2.0 * nu), nu)
            q_out = torch.where(trying & accept, q_new, q_out)
            t_out = torch.where(trying & accept, t_new, t_out)
            conv = conv | (trying & conv_now)
            accepted = accepted | (trying & accept)
            k = k + trying.to(torch.int32)
            trying = trying & ~(accept | conv_now)
            if not bool(any_lane(trying)):
                break
        q = torch.where(active, q_out, q)
        t = torch.where(active, t_out, t)
        H = torch.where(active, H_lin, H)
        lm_lambda = torch.where(active, lam, lm_lambda)
        if trace is not None:
            at = active & (slots == outer)
            trace["y0"] = torch.where(at, y0, trace["y0"])
            trace["lam_after"] = torch.where(at, lam, trace["lam_after"])
            trace["n_rejects"] = torch.where(at, k - accepted.to(torch.int32), trace["n_rejects"])
            trace["accepted"] = torch.where(at, accepted, trace["accepted"])
        it = it + active.to(torch.int32)
        active = active & ~(conv | ~accepted)
        if not bool(any_lane(active)):
            break
    if trace is not None:
        trace["n_outer"] = it
    return q, t, H, it, trace


def lm_register(src, src_cov, src_mask, vm: VoxelMap, q0, t0, cfg: SlamConfig,
                with_trace: bool = False):
    """FastVGICP::align — ``lm_drive`` over the voxel correspondences.  With
    ``with_trace`` also returns the per-outer-iteration trace (y0, λ after
    the inner loop, rejects, accepted) padded to ``vgicp_max_iterations``.
    Under ``cfg.psum_axis`` the source is this rank's block and H / b /
    costs / fitness are summed over the axis."""
    max_corr = cfg.vgicp_max_corr_dist
    probes = cfg.hash_probes

    def corr_fn(q, t):
        return find_correspondences(src, src_cov, src_mask, vm, q, t, max_corr, probes,
                                    cfg.neighbor_search)

    q, t, H, it, trace = lm_drive(corr_fn, src, q0, t0, cfg, cfg.vgicp_max_iterations,
                                  with_trace, cfg.psum_axis)
    mean_d2, n_corr = vgicp_fitness(src, src_mask, vm, q, t, max_corr, probes, cfg.psum_axis)
    result = RegistrationResult(q=q, t=t, fitness=mean_d2, n_corr=n_corr, iterations=it, H=H)
    return (result, trace) if with_trace else result
