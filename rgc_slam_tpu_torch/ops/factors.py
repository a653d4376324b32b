"""Factor library, Gauss-Newton and Ceres-style trust-region LM: the port of
``rgc_slam_tpu/ops/factors.py``.

Residual weighting follows the reference exactly (divide by ``var``, the
asymmetric ground weights var/1000 and var*10, 2*vec(q_err) rotation
residuals).  Jacobians come from ``torch.func.jacfwd`` over the tangent
step (``jacobian`` below, and ``gauss_newton``), as the JAX package uses
``jax.jacfwd``.  Every residual accepts poses with a leading batch axis
(``q [1, 4]``, ``t [1, 3]``) and the solvers' callers pass them so, because
torch's forward-mode AD leaves its fast path on 0-dim batched tensors.
``fourdof_residual`` and the matrix-free ``gauss_newton_cg`` serve the
loop-closure pose graph (``models/loop.py``).  ``plane_3pt_residual``,
``imu_delta_p_residual``, ``ground_z_residual``, ``imu_preint_residual``
and ``gauss_newton`` complete the library; the engine does not call them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd, jvp, vjp, vmap

from ..utils.axes import psum
from ..types import GroundPlane
from ..utils import math3d as m3
from ..utils.lanes import any_lane


def delta_r_residual(q, q_meas, var):
    """2 * vec(q_meas^-1 ⊗ q) / var — absolute rotation prior."""
    err = m3.quat_mul(m3.quat_conj(q_meas), q)
    return 2.0 * err[..., 1:4] / var


def relative_r_residual(q_i, q_j, q_meas, var):
    """2 * vec(q_meas^-1 ⊗ (q_i^-1 q_j)) / var."""
    qij = m3.quat_mul(m3.quat_conj(q_i), q_j)
    err = m3.quat_mul(m3.quat_conj(q_meas), qij)
    return 2.0 * err[..., 1:4] / var


def delta_p_residual(t, t_meas, var):
    return (t - t_meas) / var


class PlaneParams(NamedTuple):
    """The float fields of a GroundPlane that the ground residuals read."""

    normal: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    distance: torch.Tensor


def plane_params(g: GroundPlane) -> PlaneParams:
    return PlaneParams(g.normal, g.v1, g.v2, g.distance)


def _ground_rows(norm_cur, dist_cur, g_last, var):
    r0 = (g_last.distance - dist_cur) / (var / 1000.0)
    r1 = torch.abs((g_last.v1 * norm_cur).sum(-1)) / (var * 10.0)
    r2 = torch.abs((g_last.v2 * norm_cur).sum(-1)) / (var * 10.0)
    return torch.stack([r0, r1, r2], -1)


def ground_delta_residual(q, t, g_last, g_cur, q_w_curr_f, var):
    """Plane coplanarity between consecutive scans (3-dim, asymmetric);
    ``g_last``/``g_cur`` are GroundPlanes or PlaneParams."""
    norm_cur = m3.quat_rotate(q, g_cur.normal)
    delta_t = m3.quat_rotate(q_w_curr_f, t)
    return _ground_rows(norm_cur, g_cur.distance + delta_t[..., 2], g_last, var)


def ground_goable_residual(q, t, q_last, t_last, g_last, g_cur, q_history, var):
    """Ground_DeltaFactor_goable: the relative pose from two absolute poses
    and a historical anchor orientation."""
    q_lc = m3.quat_mul(m3.quat_conj(q_last), q)
    t_lc = m3.quat_rotate(m3.quat_conj(q_last), t - t_last)
    norm_cur = m3.quat_rotate(q_lc, g_cur.normal)
    delta_t = m3.quat_rotate(q_history, t_lc)
    return _ground_rows(norm_cur, g_cur.distance + delta_t[..., 2], g_last, var)


def pitchroll_residual(q, pitch_meas, roll_meas, var):
    ypr = m3.quat_to_ypr(q)
    return 2.0 * torch.stack([ypr[..., 1] - pitch_meas, ypr[..., 2] - roll_meas], -1) / var


def edge_residual(q, t, p, pa, pb, var):
    """Point-to-line, scaled by confidence."""
    lp = m3.quat_rotate(q, p) + t
    nu = m3.cross(lp - pa, lp - pb)
    de = m3.norm(pa - pb)
    return nu / torch.clamp(de, min=1e-9) * var


def plane_norm_residual(q, t, p, unit_norm, neg_oa_dot_norm, var):
    pw = m3.quat_rotate(q, p) + t
    return ((unit_norm * pw).sum(-1) + neg_oa_dot_norm) * var


def plane_3pt_residual(q, t, p, pj, pl, pm):
    """Point-to-plane with the plane through 3 points (``LidarPlaneFactor``,
    lidarFactor.hpp:53-89)."""
    n = m3.cross(pj - pl, pj - pm)
    n = n / torch.clamp(m3.norm(n, keepdim=True), min=1e-12)
    lp = m3.quat_rotate(q, p) + t
    return ((lp - pj) * n).sum(-1)


def imu_delta_p_residual(t, p_meas, p_rel, var):
    """2-dim xy translation prior (``IMU_DeltaPFactor``, lidarFactor.hpp:267-309)."""
    return (t + p_rel - p_meas)[..., :2] / var


def ground_z_residual(t_i, t_j, var):
    """z_i - z_j (``GroundFactor``, lidarFactor.hpp:470-488)."""
    return (t_i[..., 2] - t_j[..., 2]) / var


def imu_preint_residual(p_i, q_i, v_i, ba_i, bg_i, p_j, q_j, v_j, ba_j, bg_j,
                        delta_p, delta_q, delta_v, sum_dt, gravity: float = 9.81):
    """15-dim IMU preintegration residual [r_p, r_q, r_v, r_ba, r_bg]
    (``IntegrationBase::evaluate``, utility.h:349-379) in the VINS form,
    without the first-order bias terms (``imu.bias_corrected_delta`` has
    them)."""
    G = m3.const((0.0, 0.0, gravity), p_i.dtype, p_i.device)
    qi_inv = m3.quat_conj(q_i)
    r_p = m3.quat_rotate(qi_inv, 0.5 * G * sum_dt * sum_dt + p_j - p_i - v_i * sum_dt) - delta_p
    r_q = 2.0 * m3.quat_mul(m3.quat_conj(delta_q), m3.quat_mul(qi_inv, q_j))[..., 1:4]
    r_v = m3.quat_rotate(qi_inv, G * sum_dt + v_j - v_i) - delta_v
    return torch.cat([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], -1)


def fourdof_residual(yaw_i, t_i, yaw_j, t_j, t_ij_meas, yaw_ij_meas, pitch_i, roll_i):
    """4-DoF relative pose residual [..., 4] (radians; the PGO layer scales
    the yaw row to degrees).  Every argument may carry the same leading
    batch axis: one row per loop constraint, where the JAX package vmaps."""
    R_i = m3.ypr_to_mat(torch.stack([yaw_i, pitch_i, roll_i], -1))
    t_i_ij = torch.einsum("...ji,...j->...i", R_i, t_j - t_i)
    r_yaw = m3.wrap_angle(yaw_j - yaw_i - yaw_ij_meas)
    return torch.cat([t_i_ij - t_ij_meas, r_yaw[..., None]], -1)


def huber_rho(s: torch.Tensor, delta: float = 0.1) -> torch.Tensor:
    """Ceres HuberLoss rho(s) on squared block norms."""
    d2 = delta * delta
    return torch.where(s <= d2, s, 2.0 * delta * torch.sqrt(torch.clamp(s, min=1e-30)) - d2)


def _scaled_solve(H: torch.Tensor, g: torch.Tensor, ridge: float) -> torch.Tensor:
    """Diagonally equilibrated solve of H x = -g: residual weights span ~1e3
    (ground factors at var/1000), so an unscaled float32 solve destroys the
    weakly constrained directions."""
    dim = H.shape[0]
    s = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hs = H * s[:, None] * s[None, :] + ridge * torch.eye(dim, dtype=H.dtype, device=H.device)
    return s * torch.linalg.solve_ex(Hs, -(s * g))[0]


def gauss_newton(residual_fn: Callable, dim: int, iterations: int, damping: float = 1e-6,
                 step_clip: float = 1.0, project=None, psum_axis=None,
                 device="cuda") -> torch.Tensor:
    """``iterations`` steps x <- x + solve(JᵀJ, -Jᵀr) from x = 0 on
    ``device`` (where ``residual_fn``'s tensors live), J by
    ``torch.func.jacfwd`` cast to float32: the diagonally equilibrated
    solve with ``damping`` as the ridge before and after scaling, the step
    mapped by ``project`` (degeneracy remapping) where given, clipped to
    ``step_clip`` and dropped if not finite.  Under ``psum_axis`` the
    residual rows are this rank's block (rows replicated on every rank
    pre-scaled by rsqrt(axis size)) and H, g are summed over the axis
    before the ridge.  Returns the final tangent step."""
    x = torch.zeros(dim, dtype=torch.float32, device=device)
    eye = torch.eye(dim, dtype=torch.float32, device=device)
    for _ in range(iterations):
        r = residual_fn(x)
        J = jacfwd(residual_fn)(x).to(x.dtype)
        H, g = J.T @ J, J.T @ r
        if psum_axis is not None:
            H, g = psum(H, psum_axis), psum(g, psum_axis)
        dx = _scaled_solve(H + damping * eye, g, damping)
        if project is not None:
            dx = project @ dx
        dx = torch.clamp(dx, -step_clip, step_clip)
        x = x + torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
    return x


def _zero_tangents(tree):
    if isinstance(tree, dict):
        return {k: _zero_tangents(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_zero_tangents(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return torch.zeros_like(tree)


def jacobian(fn: Callable, x: torch.Tensor, consts) -> torch.Tensor:
    """``jacfwd`` of ``fn(x, consts)`` with respect to ``x``.

    ``consts`` (a dict/tuple pytree of float tensors: the points,
    correspondences and poses the residuals close over) enter the
    forward-mode pass with explicit zero tangents.  Mathematically that is
    ``torch.func.jacfwd(lambda x: fn(x, consts))(x)``; in practice a dual
    tensor combined with a tangent-free tensor materializes an "efficient
    zero" tangent that torch handles far off its fast path (measured 12x
    slower per op on the CPU).  The result is cast to float32 (some torch
    builds carry tangents of 0-dim intermediates in float64)."""
    zeros = _zero_tangents(consts)
    basis = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    J = vmap(lambda t: jvp(fn, (x, consts), (t, zeros))[1], out_dims=1)(basis)
    return J.to(x.dtype)


def _trust_region(linearize: Callable, trial_cost: Callable, x: torch.Tensor, iterations: int,
                  project, radius0: float, min_relative_decrease: float) -> torch.Tensor:
    """``ceres_lm``'s loop from ``x``: ``linearize(x)`` gives (H, g, cost,
    model_change), ``model_change(step)`` the model cost change of a step,
    and ``trial_cost(x)`` the robust cost at a trial point."""
    dtype, dev = x.dtype, x.device
    radius = torch.full((), radius0, dtype=dtype, device=dev)
    dec = torch.full((), 2.0, dtype=dtype, device=dev)
    for _ in range(iterations):
        H, g, cost, model_change = linearize(x)
        D = torch.clamp(torch.diagonal(H), 1e-6, 1e32) / radius
        step = _scaled_solve(H + torch.diag(D), g, 1e-6)
        if project is not None:
            step = project @ step
        mcc = model_change(step)
        new_cost = trial_cost(x + step)
        rel_decrease = (cost - new_cost) / torch.where(mcc == 0, torch.full_like(mcc, 1e-30), mcc)
        accept = (mcc > 0) & (rel_decrease > min_relative_decrease) & torch.isfinite(step).all()
        x = torch.where(accept, x + step, x)
        grow = torch.clamp(1.0 - (2.0 * rel_decrease - 1.0) ** 3, min=1.0 / 3.0)
        radius = torch.clamp(torch.where(accept, radius / grow, radius / dec), 1e-32, 1e16)
        dec = torch.where(accept, torch.full_like(dec, 2.0), dec * 2.0)
    return x


def ceres_lm(
    residual_fn: Callable,
    cost_fn: Callable,
    dim: int,
    iterations: int,
    consts,
    project=None,
    radius0: float = 1e4,
    min_relative_decrease: float = 1e-3,
    psum_axis=None,
) -> torch.Tensor:
    """Ceres trust-region LM over a tangent-parameterized residual stack
    (DENSE_QR semantics): augmentation D = clamp(diag(JᵀJ), 1e-6, 1e32) /
    radius; accept iff the model cost change is positive and the relative
    decrease exceeds 1e-3; on accept radius /= max(1/3, 1-(2ρ-1)³), on
    reject radius /= decrease factor and the factor doubles.  A fixed
    ``iterations`` count (rejected steps consume one).  ``residual_fn(x,
    consts)`` gives the loss-corrected residuals for H/g, ``cost_fn(x,
    consts)`` the true robust cost for the accept test.  Under ``psum_axis``
    the residual rows are this rank's block (rows replicated on every rank
    pre-scaled by rsqrt(axis size)), and H, g, the costs and the model
    cost change are summed over the axis.  Returns the final tangent
    step."""

    def red(x):
        return psum(x, psum_axis) if psum_axis is not None else x

    def linearize(x):
        r = residual_fn(x, consts)
        J = jacobian(residual_fn, x, consts)

        def model_change(step):
            model_res = J @ step
            return red(-(model_res * (r + model_res / 2.0)).sum())

        return red(J.T @ J), red(J.T @ r), red(cost_fn(x, consts)), model_change

    probe = next(iter(_leaves(consts)))
    x = torch.zeros(dim, dtype=torch.float32, device=probe.device)
    return _trust_region(linearize, lambda x: red(cost_fn(x, consts)), x, iterations, project,
                         radius0, min_relative_decrease)


def ceres_lm_linearized(
    linearize: Callable,
    dim: int,
    iterations: int,
    device,
    project=None,
    radius0: float = 1e4,
    min_relative_decrease: float = 1e-3,
    psum_axis=None,
) -> torch.Tensor:
    """``ceres_lm`` over a linearizer instead of the residual and cost
    functions: ``linearize(x)`` gives (H = JᵀJ, g = Jᵀr, cost) and
    ``linearize(x, derivatives=False)`` the cost (``ops/cuda/map_lm``).  J
    is never formed: the model cost change is -(stepᵀg + ½ stepᵀH step),
    algebraically ``ceres_lm``'s -(Js·(r + Js/2)).  The same trust-region
    control from x = 0 on ``device``.  Under ``psum_axis`` H, g and both
    costs are summed over the axis, which sums the model cost change as
    ``ceres_lm`` does, since it is linear in H and g.  Returns the final
    tangent step."""

    def red(x):
        return psum(x, psum_axis) if psum_axis is not None else x

    def lin(x):
        H, g, cost = (red(v) for v in linearize(x))
        return H, g, cost, lambda step: -(step @ g + 0.5 * (step @ (H @ step)))

    x = torch.zeros(dim, dtype=torch.float32, device=device)
    return _trust_region(lin, lambda x: red(linearize(x, derivatives=False)), x, iterations,
                         project, radius0, min_relative_decrease)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def degeneracy_projection(residual_fn: Callable, dim: int, eig_thresh: float, consts,
                          psum_axis=None):
    """Projection onto the well-constrained eigen-directions of JᵀJ (those
    with eigenvalue above ``eig_thresh``).  Under ``psum_axis`` the
    residual rows are this rank's block and JᵀJ is summed over the axis
    first, so every rank projects along the same eigenbasis.  JᵀJ is
    decomposed in float64 by ``utils.math3d.eigh_jacobi``, which a CUDA
    graph can hold.  Returns (P, n_degenerate)."""
    x0 = torch.zeros(dim, dtype=torch.float32, device=next(iter(_leaves(consts))).device)
    J = jacobian(residual_fn, x0, consts)
    H = J.T @ J
    if psum_axis is not None:
        H = psum(H, psum_axis)
    w, V = (x.to(H.dtype) for x in m3.eigh_jacobi(H.double()))
    keep = (w > eig_thresh).to(H.dtype)
    return (V * keep[None, :]) @ V.T, dim - keep.sum()


def _cg(A: Callable, b: torch.Tensor, maxiter: int, tol: float = 1e-5) -> torch.Tensor:
    """Conjugate gradients as ``jax.scipy.sparse.linalg.cg`` runs them (JAX
    0.9.0, no preconditioner): x0 = 0, r0 = b - A(x0), stop once
    ‖r‖² <= tol²·‖b‖² (atol = 0) or after ``maxiter`` steps.  The stop
    test is read on the host once per step; under ``torch.func.vmap`` the
    steps go on while any lane runs and a stopped lane keeps its carry, as
    the vmapped ``while_loop`` does."""
    x = torch.zeros_like(b)
    r = b - A(x)
    p = r
    gamma = (r * r).sum()
    stop2 = (tol * tol) * (b * b).sum()
    running = gamma > stop2
    for _ in range(maxiter):
        if not bool(any_lane(running)):
            break
        Ap = A(p)
        alpha = gamma / (p * Ap).sum()
        x = torch.where(running, x + alpha * p, x)
        r_new = r - alpha * Ap
        gamma_new = (r_new * r_new).sum()
        p = torch.where(running, r_new + (gamma_new / gamma) * p, p)
        r = torch.where(running, r_new, r)
        gamma = torch.where(running, gamma_new, gamma)
        running = running & (gamma > stop2)
    return x


def gauss_newton_cg(
    residual_fn: Callable,
    x0: torch.Tensor,
    gn_iters: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    consts=(),
) -> torch.Tensor:
    """Matrix-free Gauss-Newton: each step solves (JᵀJ + λI) dx = -Jᵀr by
    conjugate gradients on products with J (``torch.func.jvp``) and Jᵀ (the
    step's one ``torch.func.vjp``, reused), never materializing J; a
    non-finite dx is dropped.  ``residual_fn(x, consts)`` takes its float
    constants as ``consts`` (given zero tangents, as ``jacobian`` does) and
    may close over index tensors.  Returns x after ``gn_iters`` steps."""
    zeros = _zero_tangents(consts)
    x = x0
    for _ in range(gn_iters):
        r, vjp_fn = vjp(lambda x_: residual_fn(x_, consts), x)
        g = vjp_fn(r)[0]

        def normal_product(p, x=x, vjp_fn=vjp_fn):
            Jp = jvp(residual_fn, (x, consts), (p, zeros))[1]
            return vjp_fn(Jp.to(r.dtype))[0] + damping * p

        dx = _cg(normal_product, -g, cg_iters)
        x = x + torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
    return x
