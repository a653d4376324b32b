"""Loop closure + 4-DoF pose-graph optimization: the port of
``rgc_slam_tpu/models/loop.py``.

  * drift-adaptive candidate search: radius 15 + (travel - DistanceByLoop)
    * 0.02, travel-distance separation gate, keyframe maturity gate;
  * the latest keyframe against a ±``loop_submap_halfwidth`` keyframe
    submap, aligned by point-to-point ICP (1-NN through ``ops/knn.knn``,
    the Hopper kernel on CUDA, and closed-form Kabsch updates), or by the
    GICP / point-to-plane variants of ``ops/gicp``; accepted below
    ``loop_fitness_thresh`` with more than 100 matches;
  * the low-drift state machine (rate-limit loops after 5 consecutive
    close ones, reset after 20 m without one);
  * the 4-DoF PGO in per-edge increment coordinates, solved by the
    matrix-free ``factors.gauss_newton_cg``, re-anchored on the oldest loop
    keyframe, with the drift pushed into the mapping state.

The JAX package computes every branch under masks inside one jitted
program.  Here the compaction, ``have_cand`` and ``accepted`` flags are
read on the host (``utils.lanes.any_lane``) and the work they gate is
skipped; what is returned is what the masked program returns (with no
candidate the ICP reports fitness 0 and no matches, as the JAX ICP does on
an all-False mask).  Under ``torch.func.vmap`` (``parallel/fleet.py``) the
work runs when any lane needs it and each lane selects its own branch's
result, as under ``jax.vmap``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..types import Struct, tree_where
from ..utils import math3d as m3
from ..utils.lanes import any_lane
from ..ops import factors as fac
from ..ops import knn as knn_ops
from ..ops import voxelhash as vh
from .mapping import COMPACT_MARGIN as mapping_margin
from .mapping import MappingState
from .mapping import compact_keyframe_store as mapping_compact
from .odometry import _set_row

DRIFT_FACTOR = 0.02
MIN_LOOP_KEY = 10
RAD2DEG = 57.29577951308232


@dataclass
class LoopState(Struct):
    loop_i: torch.Tensor          # [L] int32 current-keyframe id (the "j" in FourDOF)
    loop_j: torch.Tensor          # [L] int32 history/loop keyframe id (the "i")
    loop_t: torch.Tensor          # [L, 3] t of T_loop_correct (in loop kf frame)
    loop_yaw: torch.Tensor        # [L] relative yaw of T_loop_correct
    loop_pitch_j: torch.Tensor    # [L] loop keyframe pitch at detection
    loop_roll_j: torch.Tensor     # [L]
    loop_stamp: torch.Tensor      # [L] int32 accept-order stamp (eviction age)
    loop_count: torch.Tensor      # [] int32
    last_loop_travel: torch.Tensor    # [] lastLoopDistance
    distance_by_loop: torch.Tensor    # [] DistanceByLoop
    low_drift: torch.Tensor       # [] bool
    continue_count: torch.Tensor  # [] int32
    last_kf_count: torch.Tensor   # [] int32 (new-keyframe tracking)

    @classmethod
    def init(cls, cfg: SlamConfig, device, dtype=torch.float32) -> "LoopState":
        L = cfg.max_loops
        f = dict(dtype=dtype, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            loop_i=torch.full((L,), -1, **i32),
            loop_j=torch.full((L,), -1, **i32),
            loop_t=torch.zeros((L, 3), **f),
            loop_yaw=torch.zeros((L,), **f),
            loop_pitch_j=torch.zeros((L,), **f),
            loop_roll_j=torch.zeros((L,), **f),
            loop_stamp=torch.zeros((L,), **i32),
            loop_count=torch.tensor(0, **i32),
            last_loop_travel=torch.tensor(-1000.0, **f),
            distance_by_loop=torch.tensor(0.0, **f),
            low_drift=torch.tensor(False, device=device),
            continue_count=torch.tensor(0, **i32),
            last_kf_count=torch.tensor(0, **i32),
        )


class LoopInfo(NamedTuple):
    attempted: torch.Tensor
    accepted: torch.Tensor
    candidate: torch.Tensor
    fitness: torch.Tensor
    pgo_ran: torch.Tensor


def choose_loop_slot(ls: LoopState) -> torch.Tensor:
    """The loop-store slot the next accepted constraint is written to:
    the first empty slot, else the oldest stamp, never the slot holding the
    PGO gauge anchor (the smallest history keyframe) once the store wraps
    (PARITY.md §loop-store)."""
    L = ls.loop_i.shape[0]
    dev = ls.loop_i.device
    slot_idx = torch.arange(L, device=dev)
    slot_used = ls.loop_i >= 0
    big = torch.full_like(ls.loop_j, 2**30)
    anchor_slot = torch.argmin(torch.where(slot_used, ls.loop_j, big))
    first_empty = torch.argmin(torch.where(~slot_used, slot_idx, torch.full_like(slot_idx, L)))
    evict = torch.argmin(torch.where((slot_idx != anchor_slot) | ~slot_used.any(),
                                     ls.loop_stamp, big))
    return torch.where((~slot_used).any(), first_empty, evict).to(torch.int32)


# ---------------------------------------------------------------------------
# point-to-point ICP (pcl::IterativeClosestPoint replacement)
# ---------------------------------------------------------------------------


def icp_point2point(src, src_mask, tgt, tgt_mask, max_corr, iterations: int):
    """Iterated 1-NN + weighted Kabsch over a fixed iteration count.

    Returns (q, t, fitness, n_matched) with (q, t) mapping src into tgt's
    frame; fitness is pcl's getFitnessScore(): the mean squared NN
    distance over ALL valid source points, matched or not.

    The centroids, the cross-covariance, the Kabsch solve and the fitness
    sum are taken in float64 and rounded once to float32: a batched
    reduction or 3x3 SVD (a fleet's ``fleet_loop_step``) sums in another
    order than one robot's, and 30 iterations of 1-NN matching amplify a
    float32 rounding difference, while a float64 one almost never survives
    the rounding (as the voxel segment sums, ops/voxelhash.py)."""
    dtype, dev = src.dtype, src.device
    q, t = m3.quat_identity(dev, dtype), torch.zeros(3, dtype=dtype, device=dev)
    max_corr2 = max_corr * max_corr
    for _ in range(iterations):
        sp = m3.quat_rotate(q[None, :], src) + t[None, :]
        d2, idx = knn_ops.knn(sp, tgt, tgt_mask, 1)
        w = (src_mask & (d2[:, 0] < max_corr2)).to(torch.float64)
        sp64, tp64 = sp.double(), tgt[idx[:, 0].long()].double()
        wsum = torch.clamp(w.sum(), min=1.0)
        cs = (sp64 * w[:, None]).sum(0) / wsum
        ct = (tp64 * w[:, None]).sum(0) / wsum
        H = torch.einsum("n,ni,nj->ij", w, sp64 - cs, tp64 - ct)
        U, _, Vt = m3.svd_or_nan(H)
        det = torch.linalg.det(Vt.T @ U.T)
        R = Vt.T @ torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), det])) @ U.T
        dq = m3.mat_to_quat(R.to(dtype))
        q = m3.quat_normalize(m3.quat_mul(dq, q))
        t = m3.quat_rotate(dq, t) + (ct - R @ cs).to(dtype)
    sp = m3.quat_rotate(q[None, :], src) + t[None, :]
    d2, _ = knn_ops.knn(sp, tgt, tgt_mask, 1)
    n = (src_mask & (d2[:, 0] < max_corr2)).sum().to(torch.int32)
    n_valid = src_mask.sum()
    fitness = (torch.where(src_mask, d2[:, 0].double(), torch.zeros((), dtype=torch.float64,
                                                                     device=dev)).sum()
               / torch.clamp(n_valid, min=1)).to(dtype)
    return q, t, fitness, n


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _kf_cloud_world(ms: MappingState, k, cap_c: int, cap_s: int):
    """Keyframe k's corner+surf cloud in world frame; ``k`` may be a
    tensor of ids, giving one cloud per id."""
    q, t = ms.kf_q[k], ms.kf_t[k]
    c = m3.quat_rotate(q[..., None, :], ms.kf_corner[k]) + t[..., None, :]
    s = m3.quat_rotate(q[..., None, :], ms.kf_surf[k]) + t[..., None, :]
    return (torch.cat([c, s], -2),
            torch.cat([ms.kf_corner_mask[k], ms.kf_surf_mask[k]], -1))


def _maybe_compact(state, ls: LoopState, cfg: SlamConfig):
    """Compact the keyframe store when its headroom drops below
    COMPACT_MARGIN, remapping the loop store's keyframe indices.  Loop
    endpoints are protected from eviction; if protection leaves nothing
    evictable the unprotected rule runs and loops whose endpoint died are
    dropped (masked to -1)."""
    ms = state.mapping
    K = ms.kf_q.shape[0]
    need = ms.kf_count >= K - mapping_margin
    if not bool(any_lane(need)):
        return state, ls
    anchored = torch.zeros(K, dtype=torch.int32, device=ms.kf_q.device)
    for ix in (ls.loop_i, ls.loop_j):
        anchored = anchored.scatter_reduce(0, torch.clamp(ix, 0, K - 1).long(),
                                           (ix >= 0).to(torch.int32), "amax", include_self=True)
    ms2, keep, new_of_old = mapping_compact(ms, protect=anchored > 0)

    def remap(ix):
        safe = torch.clamp(ix, 0, K - 1).long()
        ok = (ix >= 0) & keep[safe]
        return torch.where(ok, new_of_old[safe], torch.full_like(ix, -1))

    li, lj = remap(ls.loop_i), remap(ls.loop_j)
    both = (li >= 0) & (lj >= 0)
    idx = torch.arange(K, device=ms.kf_q.device)
    ev_below = ((~keep) & (idx < ms.kf_count) & (idx < ls.last_kf_count)).sum()
    ls2 = ls.replace(
        loop_i=torch.where(both, li, torch.full_like(li, -1)),
        loop_j=torch.where(both, lj, torch.full_like(lj, -1)),
        last_kf_count=torch.clamp(ls.last_kf_count - ev_below, min=0).to(torch.int32),
    )
    return tree_where(need, (state.replace(mapping=ms2), ls2), (state, ls))


def _loop_icp(src, src_mask, tgt, tgt_mask, max_corr, cfg: SlamConfig):
    """The registration ``cfg.loop_icp_method`` selects:
    (q, t, fitness, n_matched)."""
    if cfg.loop_icp_method in ("gicp", "plane"):
        from ..ops import gicp

        register = gicp.gicp_register if cfg.loop_icp_method == "gicp" else gicp.p2plane_register
        q0 = m3.quat_identity(src.device, src.dtype)
        res = register(src, src_mask, tgt, tgt_mask, q0, torch.zeros_like(q0[1:]), cfg,
                       max_iters=cfg.loop_icp_iterations)
        return res.q, res.t, res.fitness, res.n_corr
    return icp_point2point(src, src_mask, tgt, tgt_mask, max_corr, cfg.loop_icp_iterations)


def loop_closure_step(state, loop_state: LoopState, cfg: SlamConfig):
    """One loop-closure opportunity: compaction, candidate search, submap
    ICP, constraint store, drift state machine and (when a loop was
    accepted) the PGO.  Returns (state, loop_state, LoopInfo)."""
    enabled = cfg.loop_closure_enable and cfg.map_update
    if enabled:
        state, loop_state = _maybe_compact(state, loop_state, cfg)
    ms = state.mapping
    ls = loop_state
    dtype, dev = ms.t_md.dtype, ms.t_md.device
    K = ms.kf_q.shape[0]

    latest = torch.clamp(ms.kf_count - 1, 0, K - 1)
    travel_latest = ms.kf_travel[latest]
    new_kf = ms.kf_count > ls.last_kf_count
    since_loop = torch.abs(travel_latest - ls.last_loop_travel)
    rate_ok = torch.where(ls.low_drift, since_loop >= 5.0, torch.ones_like(ls.low_drift))
    low_drift = torch.where(since_loop > 20.0, torch.zeros_like(ls.low_drift), ls.low_drift)
    # localization mode runs no loop detection
    attempt = enabled & new_kf & rate_ok & (ms.kf_count > MIN_LOOP_KEY + 2)

    # ---- candidate search (detectLoopClosure) ----
    radius = cfg.loop_search_radius + (travel_latest - ls.distance_by_loop) * DRIFT_FACTOR
    kf_idx = torch.arange(K, device=dev)
    valid = kf_idx < ms.kf_count
    d = m3.norm(ms.kf_t - ms.kf_t[latest][None, :])
    # maturity gate in travel, so it survives compaction relabelling slots
    mature = ms.kf_travel >= MIN_LOOP_KEY * cfg.keyframe_dist
    eligible = (valid & mature & (kf_idx != latest) & (d < radius)
                & (torch.abs(ms.kf_travel - travel_latest) > (cfg.loop_travel_gate + radius)))
    d_masked = torch.where(eligible, d, torch.full_like(d, torch.inf))
    cand = torch.argmin(d_masked).to(torch.int32)
    have_cand = torch.isfinite(d_masked[cand]) & attempt

    q_icp, t_icp = m3.quat_identity(dev, dtype), torch.zeros(3, dtype=dtype, device=dev)
    fitness = torch.zeros((), dtype=dtype, device=dev)
    n_icp = torch.zeros((), dtype=torch.int32, device=dev)
    origin = ms.kf_t[cand]
    if bool(any_lane(have_cand)):
        # ---- submap: ±halfwidth keyframes around the candidate ----
        W = cfg.loop_submap_halfwidth
        ids = cand + torch.arange(-W, W + 1, device=dev, dtype=torch.int32)
        sub_ids = torch.clamp(ids, 0, K - 1).long()
        sub_ok = (ids >= 0) & (ids < latest) & valid[sub_ids]
        sub_pts, sub_mask = _kf_cloud_world(ms, sub_ids, cfg.max_kf_corner, cfg.max_kf_surf)
        sub_mask = sub_mask & sub_ok[:, None]
        tgt, tgt_mask, _ = vh.voxel_downsample(
            sub_pts.reshape(-1, 3) - origin[None, :], sub_mask.reshape(-1),
            cfg.loop_submap_voxel or cfg.map_surf_voxel, cfg.max_loop_submap_points,
            probes=cfg.hash_probes,
        )
        src, src_mask = _kf_cloud_world(ms, latest, cfg.max_kf_corner, cfg.max_kf_surf)
        icp = _loop_icp(src - origin[None, :], src_mask, tgt, tgt_mask, 2.0 * radius, cfg)
        q_icp, t_icp, fitness, n_icp = tree_where(have_cand, icp, (q_icp, t_icp, fitness, n_icp))
    accepted = have_cand & (fitness < cfg.loop_fitness_thresh) & (n_icp > 100)

    if bool(any_lane(accepted)):
        # ---- loop constraint from the ICP drift (T_loop_correct) ----
        t_drift = t_icp + origin - m3.quat_rotate(q_icp, origin)
        q_latest, t_latest = ms.kf_q[latest], ms.kf_t[latest]
        q_corr = m3.quat_normalize(m3.quat_mul(q_icp, q_latest))
        t_corr = m3.quat_rotate(q_icp, t_latest) + t_drift
        q_loop, t_loop = ms.kf_q[cand], ms.kf_t[cand]
        q_rel = m3.quat_mul(m3.quat_conj(q_loop), q_corr)
        t_rel = m3.quat_rotate(m3.quat_conj(q_loop), t_corr - t_loop)
        ypr_rel = m3.quat_to_ypr(q_rel)
        ypr_loop = m3.quat_to_ypr(q_loop)
        wi = choose_loop_slot(ls)
        stored = ls.replace(
            loop_i=_set_row(ls.loop_i, wi, latest), loop_j=_set_row(ls.loop_j, wi, cand),
            loop_t=_set_row(ls.loop_t, wi, t_rel), loop_yaw=_set_row(ls.loop_yaw, wi, ypr_rel[0]),
            loop_pitch_j=_set_row(ls.loop_pitch_j, wi, ypr_loop[1]),
            loop_roll_j=_set_row(ls.loop_roll_j, wi, ypr_loop[2]),
            loop_stamp=_set_row(ls.loop_stamp, wi, ls.loop_count + 1),
            loop_count=ls.loop_count + 1,
        )
        ls = tree_where(accepted, stored, ls)

    # drift state machine (RGC_mapping.cpp:2125-2138)
    cont = torch.where(
        accepted,
        torch.where(since_loop < 10.0, ls.continue_count + 1, torch.zeros_like(ls.continue_count)),
        ls.continue_count,
    )
    low_drift = torch.where(accepted & (cont > 4), torch.ones_like(low_drift), low_drift)
    dbl = torch.clamp(travel_latest - ms.kf_travel[cand], min=0.0)
    ls = ls.replace(
        continue_count=cont.to(torch.int32),
        low_drift=low_drift,
        distance_by_loop=torch.where(accepted, dbl, ls.distance_by_loop),
        last_loop_travel=torch.where(accepted, travel_latest, ls.last_loop_travel),
        last_kf_count=ms.kf_count,
    )

    # ---- 4-DoF PGO (only when a loop was just added) ----
    state, pgo_ran = _pose_graph_optimize(state, ls, accepted, cfg)
    info = LoopInfo(attempted=attempt, accepted=accepted, candidate=cand, fitness=fitness,
                    pgo_ran=pgo_ran)
    return state, ls, info


def _pose_graph_optimize(state, ls: LoopState, run: torch.Tensor, cfg: SlamConfig):
    """Run the 4-DoF solve when ``run`` (read on the host) is set; under
    vmap when it is set in any lane, each lane keeping its own branch."""
    if bool(any_lane(run)):
        state = state.replace(mapping=tree_where(run, _pgo_solve(state.mapping, ls, cfg),
                                                 state.mapping))
    return state, run


def _pgo_residuals(x, c):
    """Chain and loop residuals of the PGO at increment vector ``x``
    (``c``: the constants of ``_pgo_solve``).  The chain rows are
    ``fourdof_residual`` at the reconstructed poses, which in increment
    coordinates is this closed form; the yaw rows are in degrees."""
    K = c["pitch0"].shape[0]
    dyaw, dt = x[:K] / c["rad2deg"], x[K:].reshape(K, 3)
    r_chain = torch.cat([
        (dt[1:] - c["t_ij_meas"]) * c["chain_w"][:, None],
        (m3.wrap_angle(dyaw[1:] - c["yaw_ij_meas"]) * c["rad2deg"] * c["chain_w"])[:, None],
    ], 1)
    yaw, t = _pgo_reconstruct(x, c)
    li, lj = c["li"], c["lj"]
    r_loop = fac.fourdof_residual(
        yaw[lj], t[lj], yaw[li], t[li],
        c["loop_t"], c["loop_yaw"], c["loop_pitch_j"], c["loop_roll_j"],
    ) * c["yaw_scale"] * c["loop_w"][:, None]
    return torch.cat([r_chain.reshape(-1), r_loop.reshape(-1)])


def _pgo_reconstruct(x, c):
    """Absolute (yaw, t) from the increments: two cumulative sums."""
    K = c["pitch0"].shape[0]
    yaw = torch.cumsum(x[:K] / c["rad2deg"], 0)
    dt = x[K:].reshape(K, 3)
    R = m3.ypr_to_mat(torch.stack([yaw, c["pitch0"], c["roll0"]], -1))
    steps = torch.cat([dt[:1], torch.einsum("kij,kj->ki", R[:-1], dt[1:])], 0)
    return yaw, torch.cumsum(steps, 0)


def _pgo_solve(ms: MappingState, ls: LoopState, cfg: SlamConfig) -> MappingState:
    """4-DoF pose-graph solve in PER-EDGE INCREMENT coordinates.

    Variables are per-edge (dyaw_k, dt_k), entry 0 holding the absolute
    base pose, so the chain block of JᵀJ is the identity and CG converges in
    ~4·n_loops iterations whatever K (see the JAX module for the
    derivation).  Yaw is carried in degrees, as the reference's FourDOF
    factor does, which weights yaw errors 180/π times the translation rows.
    The damping holds the gauge; afterwards the solution is re-anchored so
    that the oldest loop keyframe keeps its pose exactly, and the latest
    keyframe's correction is applied to the map->odom and last poses."""
    dtype, dev = ms.t_md.dtype, ms.t_md.device
    K = ms.kf_q.shape[0]
    valid = torch.arange(K, device=dev) < ms.kf_count

    ypr0 = m3.quat_to_ypr(ms.kf_q)
    yaw0, pitch0, roll0 = ypr0[:, 0], ypr0[:, 1], ypr0[:, 2]
    t0 = ms.kf_t
    Ri0 = m3.ypr_to_mat(ypr0)
    t_ij_meas = torch.einsum("kji,kj->ki", Ri0[:-1], t0[1:] - t0[:-1])
    yaw_ij_meas = m3.wrap_angle(yaw0[1:] - yaw0[:-1])
    rad2deg = torch.tensor(RAD2DEG, dtype=dtype, device=dev)

    loops_ok = (ls.loop_i >= 0) & (ls.loop_i < ms.kf_count) & (ls.loop_j >= 0)
    lj = torch.clamp(ls.loop_j, 0, K - 1)
    # pin the oldest loop keyframe (RGC_mapping.cpp:2404-2419)
    pinned = torch.clamp(torch.where(loops_ok, lj, torch.full_like(lj, K)).min(), 0, K - 1).long()

    consts = dict(
        pitch0=pitch0, roll0=roll0, t_ij_meas=t_ij_meas, yaw_ij_meas=yaw_ij_meas,
        chain_w=(valid[1:] & valid[:-1]).to(dtype), rad2deg=rad2deg,
        yaw_scale=torch.stack([torch.ones_like(rad2deg)] * 3 + [rad2deg]),
        loop_w=loops_ok.to(dtype), loop_t=ls.loop_t, loop_yaw=ls.loop_yaw,
        loop_pitch_j=ls.loop_pitch_j, loop_roll_j=ls.loop_roll_j,
    )
    index = dict(li=torch.clamp(ls.loop_i, 0, K - 1).long(), lj=lj.long())

    def residuals(x, c):
        return _pgo_residuals(x, {**c, **index})

    x0 = torch.cat([
        torch.cat([yaw0[:1], yaw_ij_meas]) * rad2deg,
        torch.cat([t0[:1], t_ij_meas], 0).reshape(-1),
    ])
    x_opt = fac.gauss_newton_cg(residuals, x0, gn_iters=cfg.pgo_iterations,
                                cg_iters=cfg.pgo_cg_iters, damping=1e-6, consts=consts)
    yaw_new, t_new = _pgo_reconstruct(x_opt, consts)

    # re-anchor: the 4-DoF transform keeping the pinned keyframe's pose
    dgauge = m3.wrap_angle(yaw0[pinned] - yaw_new[pinned])
    zero = torch.zeros_like(dgauge)
    Rg = m3.ypr_to_mat(torch.stack([dgauge, zero, zero]))
    yaw_new = yaw_new + dgauge
    t_new = torch.einsum("ij,kj->ki", Rg, t_new - t_new[pinned][None, :]) + t0[pinned][None, :]
    yaw_new = torch.where(valid, yaw_new, yaw0)
    t_new = torch.where(valid[:, None], t_new, t0)
    q_new = m3.ypr_to_quat(torch.stack([yaw_new, pitch0, roll0], -1))

    # drift of the latest keyframe, applied to the mapping frame
    latest = torch.clamp(ms.kf_count - 1, 0, K - 1)
    q_dr = m3.quat_normalize(m3.quat_mul(q_new[latest], m3.quat_conj(ms.kf_q[latest])))
    t_dr = t_new[latest] - m3.quat_rotate(q_dr, ms.kf_t[latest])

    def apply(q, t):
        return m3.quat_normalize(m3.quat_mul(q_dr, q)), m3.quat_rotate(q_dr, t) + t_dr

    q_md, t_md = apply(ms.q_md, ms.t_md)
    q_l, t_l = apply(ms.q_w_last, ms.t_w_last)
    q_l2, t_l2 = apply(ms.q_w_last2, ms.t_w_last2)
    return ms.replace(kf_q=q_new, kf_t=t_new, q_md=q_md, t_md=t_md,
                      q_w_last=q_l, t_w_last=t_l, q_w_last2=q_l2, t_w_last2=t_l2)
