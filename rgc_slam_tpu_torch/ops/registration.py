"""VGICP scan-to-submap registration: the port of
``rgc_slam_tpu/ops/registration.py``.

``lm_drive`` keeps the reference's λ schedule (ρ gain ratio, ν doubling),
so3 retraction and rotation/translation convergence tests; ``lm_register``
(VGICP) and ``ops/gicp``'s GICP, point-to-plane ICP and NDT all run it (NDT
with the pose-dependent Cauchy weights of ``_robust_w``, ``cauchy_k``).  The
JAX package's nested ``lax.while_loop``s with early exit become Python loops
of their static counts that read nothing back to the host: a finished lane
keeps its carry by ``torch.where``, which is also what ``jax.vmap`` makes of
the while loops, so the step can be captured into one CUDA graph
(``utils/graph``), where each iteration's body sits under a conditional
IF node and a replay skips the iterations past the exit (``lm_drive``'s
conditional loop); the per-outer-iteration λ trace is kept, so the
λ-schedule parity gate applies to the port unchanged.  Correspondences stay frozen between linearization
and the LM accept test (reference semantics).  With ``psum_axis`` (the sp
axis of a sharded step, ``utils/axes``) each rank linearizes its
block of the source and the 6x6 H, b and costs are summed over the axis.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.utils._pytree as pytree

from ..config import SlamConfig
from ..utils.axes import psum
from ..types import VoxelMap
from ..utils import math3d as m3
from . import voxelhash as vh
from .cuda import graph_if


class RegistrationResult(NamedTuple):
    q: torch.Tensor           # [4] target <- source
    t: torch.Tensor           # [3]
    fitness: torch.Tensor     # [] mean squared correspondence error
    n_corr: torch.Tensor      # [] correspondences at the solution
    iterations: torch.Tensor  # [] outer LM iterations
    H: torch.Tensor           # [6, 6] final Hessian


class LMResult(NamedTuple):
    """``lm_register``'s result: ``RegistrationResult``'s fields, then the
    inner LM iterations summed over the outer ones and the bodies of
    ``lm_drive`` that ran."""

    q: torch.Tensor
    t: torch.Tensor
    fitness: torch.Tensor
    n_corr: torch.Tensor
    iterations: torch.Tensor
    H: torch.Tensor
    inner: torch.Tensor       # []
    bodies: torch.Tensor      # [] int32


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """Within the block torch's CUDA linear algebra prefers cuSOLVER (a
    CPU ``device`` changes nothing).  A batched ``cholesky_solve`` (the
    fleet's, under vmap) otherwise goes to MAGMA, which allocates device
    memory inside the call, so a CUDA graph cannot hold it; one system at a
    time goes to cuSOLVER either way, bit for bit the same (``chip_smoke.py``
    phase 12)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _factor6(H: torch.Tensor, damping):
    """(L, ok): the Cholesky factor of H + damping I, I where that is not
    PD, and whether it is."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(H + damping * eye + 1e-8 * eye)
    ok = (info == 0) & torch.isfinite(L).all()
    return torch.where(ok, L, eye), ok


def _solve_factored(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d with L Lᵀ d = -b (cuSOLVER's ``potrs`` on the card, which allocates
    stream-ordered memory: a conditional node's body cannot hold it)."""
    with _cusolver(L.device):
        return torch.cholesky_solve(-b[:, None], L)[:, 0]


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
    offsets = m3.const(tuple(NEIGHBOR_OFFSETS[neighbors]), torch.int32, src.device)
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
    k2 = torch.full((), cauchy_k * cauchy_k, dtype=err.dtype, device=err.device)
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


class _Carry:
    """``lm_drive``'s carries, by name.  Masked (``in_place`` False), a
    write rebinds the name, as the loop rebinds its locals (what vmap's
    lanes need).  In place, a name's first write clones its value into a
    buffer and each later write copies into that buffer, so a buffer keeps
    its storage: a body captured under an IF node writes it, and a skipped
    body leaves it as it was."""

    def __init__(self, in_place: bool):
        self._in_place = in_place

    def put(self, **values):
        for name, value in values.items():
            old = self.__dict__.get(name)
            if not self._in_place:
                setattr(self, name, value)
            elif old is None:
                setattr(self, name, pytree.tree_map(torch.clone, value))
            else:
                for dst, src in zip(pytree.tree_leaves(old), pytree.tree_leaves(value)):
                    dst.copy_(src)


def _masked(pred, body):
    body()


def _conditional(src, with_trace: bool, psum_axis):
    """The IF node the LM's bodies are captured under, or None for the
    masked loop: an IF node only while the current stream captures a
    CUDA graph, for one unbatched LM (no vmap or other functorch transform
    around it), without ``psum_axis`` and without the λ trace."""
    if (with_trace or psum_axis is not None or src.device.type != "cuda"
            or torch._C._functorch.peek_interpreter_stack() is not None
            or not torch.cuda.is_current_stream_capturing()):
        return None
    return graph_if.if_node


def lm_drive(corr_fn, src, q0, t0, cfg: SlamConfig, max_iters: int, with_trace: bool = False,
             psum_axis=None, cauchy_k=None):
    """The LsqRegistration LM loop over any frozen-correspondence function
    ``corr_fn(q, t) -> Correspondences``: λ from the gain ratio ρ, ν
    doubling, so3 retraction, rotation/translation convergence; with
    ``psum_axis`` the linearization and the trial costs are summed over
    the axis, so every rank takes the same steps; with ``cauchy_k`` (NDT)
    both use the pose-dependent Cauchy weights of ``_robust_w``.  Returns
    (q, t, H of the last linearization, outer iterations, inner iterations
    summed over the outer ones, bodies run, trace); with ``with_trace`` the
    trace holds per outer iteration (y0, λ after the inner loop, rejects,
    accepted) padded to ``max_iters``, else it is None.

    Both loops run their static counts (``max_iters`` outer slots,
    ``cfg.lm_max_inner`` inner steps a slot) and never read the device.  A
    slot is its outer body (correspondences, linearization, λ, the inner
    loop's carries, the first step's factor of the damped system), its inner
    steps and its write-back into the outer carries; an inner step is the
    solve (cuSOLVER's ``potrs``, ``_solve_factored``), then its body: the
    step's test and update and the next step's factor.  ``trying`` is set to
    ``active`` at the top of every slot, outside every body.  Every write
    merges by ``torch.where`` on the lane's flag (``active`` for the outer
    body and the write-back, ``trying`` for an inner step), so a lane that
    has stopped (its early exit in the JAX package's nested
    ``lax.while_loop``s) keeps every carry and the trace, and the results
    equal the early-exit loops' bit for bit.

    Two loops run the same bodies.  The masked loop runs every body, one
    stream or under ``torch.func.vmap``: the iterations past a lane's exit
    are computed and dropped.  While the current stream captures a CUDA
    graph, for one LM without ``psum_axis`` and without the trace, the
    conditional loop captures each body under an IF node on its flag
    (``ops/cuda/graph_if``), one after another, none nested, so a replay
    skips a stopped lane's bodies; where the flag holds ``torch.where``
    takes the new value, so the bits are the masked loop's.  Its bodies
    write in place into buffers made outside them, by slot 0's outer body,
    which runs unconditioned (``active`` holds there).  The solve stays
    outside the IF nodes (a conditional body cannot hold ``potrs``) and runs
    in every inner slot.  ``bodies`` counts an outer body, a write-back and
    an inner step each as one: the static 2 x ``max_iters`` + ``max_iters``
    x ``lm_max_inner`` masked, 2 x outer + inner iterations conditional."""
    dtype, dev = src.dtype, src.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    if_node = _conditional(src, with_trace, psum_axis)
    run = _masked if if_node is None else if_node

    def is_converged(dq, dt_):
        r_ok = torch.abs(m3.quat_to_mat(dq) - eye3).max() / cfg.rotation_epsilon
        t_ok = torch.abs(dt_).max() / cfg.translation_epsilon
        return torch.maximum(r_ok, t_ok) < 1.0

    c = _Carry(in_place=if_node is not None)
    c.put(q=q0.to(dtype), t=t0.to(dtype), lm_lambda=torch.full((), -1.0, dtype=dtype, device=dev),
          H=torch.zeros((6, 6), dtype=dtype, device=dev),
          it=torch.zeros((), dtype=torch.int32, device=dev),
          inner=torch.zeros((), dtype=torch.int32, device=dev),
          active=torch.ones((), dtype=torch.bool, device=dev),
          bodies=torch.zeros((), dtype=torch.int32, device=dev))

    def outer_body():
        corr = corr_fn(c.q, c.t)
        H_lin, b, y0 = corr_linearize(corr, src, c.q, c.t, psum_axis, cauchy_k)
        lam = torch.where(c.lm_lambda < 0,
                          cfg.lm_init_lambda_factor * torch.abs(torch.diagonal(H_lin)).max(),
                          c.lm_lambda)
        L, ok = _factor6(H_lin, lam)             # the first inner step's
        c.put(corr=corr, H_lin=H_lin, b=b, y0=y0, lam=lam,
              nu=torch.full((), 2.0, dtype=dtype, device=dev), q_out=c.q, t_out=c.t,
              conv=torch.zeros((), dtype=torch.bool, device=dev),
              accepted=torch.zeros((), dtype=torch.bool, device=dev),
              k=torch.zeros((), dtype=torch.int32, device=dev), L=L, ok=ok,
              bodies=c.bodies + 1)

    def inner_step(d, last: bool):
        lam, nu, trying = c.lam, c.nu, c.trying
        d = torch.where(c.ok, d, torch.zeros_like(d))       # no step where not PD
        dq = m3.quat_exp(d[:3])
        dt_ = d[3:]
        q_new = m3.quat_normalize(m3.quat_mul(dq, c.q))
        t_new = m3.quat_rotate(dq, c.t) + dt_
        yi = corr_cost(c.corr, src, q_new, t_new, psum_axis, cauchy_k)
        denom = torch.dot(d, lam * d - c.b)
        rho = (c.y0 - yi) / torch.where(torch.abs(denom) < 1e-12,
                                        torch.full_like(denom, 1e-12), denom)
        accept = rho > 0
        conv_now = is_converged(dq, dt_)
        c.put(lam=torch.where(trying, torch.where(
                  accept, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                  nu * lam), lam),
              nu=torch.where(trying, torch.where(accept, torch.full_like(nu, 2.0), 2.0 * nu), nu),
              q_out=torch.where(trying & accept, q_new, c.q_out),
              t_out=torch.where(trying & accept, t_new, c.t_out),
              conv=c.conv | (trying & conv_now), accepted=c.accepted | (trying & accept),
              k=c.k + trying.to(torch.int32), trying=trying & ~(accept | conv_now),
              bodies=c.bodies + 1)
        if not last:                    # the next step's factor
            L, ok = _factor6(c.H_lin, c.lam)
            c.put(L=L, ok=ok)

    def write_back():
        active = c.active
        c.put(q=torch.where(active, c.q_out, c.q), t=torch.where(active, c.t_out, c.t),
              H=torch.where(active, c.H_lin, c.H),
              lm_lambda=torch.where(active, c.lam, c.lm_lambda),
              it=c.it + active.to(torch.int32), inner=c.inner + c.k,
              active=active & ~(c.conv | ~c.accepted), bodies=c.bodies + 1)

    trace = None
    if with_trace:
        trace = {"y0": torch.full((max_iters,), torch.nan, dtype=dtype, device=dev),
                 "lam_after": torch.full((max_iters,), torch.nan, dtype=dtype, device=dev),
                 "n_rejects": torch.zeros((max_iters,), dtype=torch.int32, device=dev),
                 "accepted": torch.zeros((max_iters,), dtype=torch.bool, device=dev)}
        slots = torch.arange(max_iters, device=dev)
    for outer in range(max_iters):
        # outside every body: a lane that left the last slot's inner loop at
        # its cap with ``trying`` set has ``active`` cleared by now
        c.put(trying=c.active)
        if outer:
            run(c.active, outer_body)
        else:
            outer_body()        # ``active`` holds; its first writes make the buffers
        for step in range(cfg.lm_max_inner):
            d = _solve_factored(c.L, c.b)        # unconditioned: potrs
            run(c.trying, lambda: inner_step(d, step == cfg.lm_max_inner - 1))
        if trace is not None:
            at = c.active & (slots == outer)
            trace["y0"] = torch.where(at, c.y0, trace["y0"])
            trace["lam_after"] = torch.where(at, c.lam, trace["lam_after"])
            trace["n_rejects"] = torch.where(at, c.k - c.accepted.to(torch.int32),
                                             trace["n_rejects"])
            trace["accepted"] = torch.where(at, c.accepted, trace["accepted"])
        run(c.active, write_back)
    if trace is not None:
        trace["n_outer"] = c.it
    return c.q, c.t, c.H, c.it, c.inner, c.bodies, trace


def lm_register(src, src_cov, src_mask, vm: VoxelMap, q0, t0, cfg: SlamConfig,
                with_trace: bool = False):
    """FastVGICP::align — ``lm_drive`` over the voxel correspondences, as an
    ``LMResult``.  With ``with_trace`` also returns the per-outer-iteration
    trace (y0, λ after the inner loop, rejects, accepted) padded to
    ``vgicp_max_iterations``.
    Under ``cfg.psum_axis`` the source is this rank's block and H / b /
    costs / fitness are summed over the axis."""
    max_corr = cfg.vgicp_max_corr_dist
    probes = cfg.hash_probes

    def corr_fn(q, t):
        return find_correspondences(src, src_cov, src_mask, vm, q, t, max_corr, probes,
                                    cfg.neighbor_search)

    q, t, H, it, inner, bodies, trace = lm_drive(corr_fn, src, q0, t0, cfg,
                                                 cfg.vgicp_max_iterations, with_trace,
                                                 cfg.psum_axis)
    mean_d2, n_corr = vgicp_fitness(src, src_mask, vm, q, t, max_corr, probes, cfg.psum_axis)
    result = LMResult(q=q, t=t, fitness=mean_d2, n_corr=n_corr, iterations=it, H=H, inner=inner,
                      bodies=bodies)
    return (result, trace) if with_trace else result
