"""Mapping back-end: the port of ``rgc_slam_tpu/models/mapping.py``.

Surrounding-keyframe map assembly -> two-pose scan-to-map optimization
(5-NN corner line fits and surf plane fits for the current and previous
frames, frozen per outer iteration; IMU relative rotation, absolute
pitch/roll and ground-plane factors; a 12-dim Ceres-style trust-region LM)
-> map->odom update -> keyframe gating, with inline keyframe compaction
when loop closure is off.  The kNN association (8 calls per scan at
``map_opt_iterations=2``) runs through ``ops/knn.knn``, the Hopper kernel
on CUDA.  Under an sp mesh (``cfg.psum_axis``) each rank associates and
linearizes a block of the query clouds and the solves sum over the axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..utils.axes import axis_index, psum
from ..types import GroundPlane, Struct, tree_where
from ..utils import math3d as m3
from ..utils.lanes import any_lane
from ..ops import factors as fac
from ..ops import knn as knn_ops
from ..ops import voxelhash as vh
from ..ops.covariance import eigh3x3
from .odometry import OdometryOutput, _set_row

HIST_CAP = 64
RAD2DEG = 57.29577951308232

# Keyframe-store compaction headroom (see the JAX module).
COMPACT_MARGIN = 16


def worst_cadence_gap(loop_cadence: int, chunk: int) -> int:
    """Max scans between loop-closure/compaction opportunities when the
    cadence is evaluated only at chunk boundaries."""
    chunk = max(chunk, 1)
    if chunk >= loop_cadence:
        return chunk
    r = loop_cadence % chunk
    return loop_cadence + (chunk - r if r else 0)


@dataclass
class MappingState(Struct):
    q_md: torch.Tensor
    t_md: torch.Tensor
    q_w_last: torch.Tensor
    t_w_last: torch.Tensor
    q_w_last2: torch.Tensor
    t_w_last2: torch.Tensor
    last_corner: torch.Tensor       # [C, 3]
    last_corner_conf: torch.Tensor
    last_corner_mask: torch.Tensor
    last_surf: torch.Tensor         # [S, 3]
    last_surf_conf: torch.Tensor
    last_surf_mask: torch.Tensor
    ground_last: GroundPlane
    ground_last2: GroundPlane
    gflag: torch.Tensor
    change_count: torch.Tensor
    q_w_delta: torch.Tensor
    hist_q: torch.Tensor            # [HIST_CAP, 4]
    hist_count: torch.Tensor
    imu_ypr_last: torch.Tensor      # [3]
    count: torch.Tensor
    kf_q: torch.Tensor              # [K, 4]
    kf_t: torch.Tensor              # [K, 3]
    kf_stamp: torch.Tensor
    kf_travel: torch.Tensor
    kf_corner: torch.Tensor         # [K, C, 3]
    kf_corner_conf: torch.Tensor
    kf_corner_mask: torch.Tensor
    kf_surf: torch.Tensor           # [K, S, 3]
    kf_surf_conf: torch.Tensor
    kf_surf_mask: torch.Tensor
    kf_count: torch.Tensor
    travel_dist: torch.Tensor

    @classmethod
    def init(cls, cfg: SlamConfig, device, dtype=torch.float32) -> "MappingState":
        K, C, S = cfg.max_keyframes, cfg.max_kf_corner, cfg.max_kf_surf
        f = dict(dtype=dtype, device=device)
        b = dict(dtype=torch.bool, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        qi = m3.quat_identity(device, dtype)
        return cls(
            q_md=qi.clone(), t_md=torch.zeros(3, **f),
            q_w_last=qi.clone(), t_w_last=torch.zeros(3, **f),
            q_w_last2=qi.clone(), t_w_last2=torch.zeros(3, **f),
            last_corner=torch.zeros((C, 3), **f), last_corner_conf=torch.zeros((C,), **f),
            last_corner_mask=torch.zeros((C,), **b),
            last_surf=torch.zeros((S, 3), **f), last_surf_conf=torch.zeros((S,), **f),
            last_surf_mask=torch.zeros((S,), **b),
            ground_last=GroundPlane.default(cfg.lidar_height, device, dtype),
            ground_last2=GroundPlane.default(cfg.lidar_height, device, dtype),
            gflag=torch.tensor(0, **i32), change_count=torch.tensor(0, **i32),
            q_w_delta=qi.clone(), hist_q=qi.repeat(HIST_CAP, 1),
            hist_count=torch.tensor(0, **i32), imu_ypr_last=torch.zeros(3, **f),
            count=torch.tensor(0, **i32),
            kf_q=qi.repeat(K, 1), kf_t=torch.zeros((K, 3), **f),
            kf_stamp=torch.zeros((K,), **f), kf_travel=torch.zeros((K,), **f),
            kf_corner=torch.zeros((K, C, 3), **f), kf_corner_conf=torch.zeros((K, C), **f),
            kf_corner_mask=torch.zeros((K, C), **b),
            kf_surf=torch.zeros((K, S, 3), **f), kf_surf_conf=torch.zeros((K, S), **f),
            kf_surf_mask=torch.zeros((K, S), **b),
            kf_count=torch.tensor(0, **i32), travel_dist=torch.tensor(0.0, **f),
        )


class MappingOutput(NamedTuple):
    q_w: torch.Tensor
    t_w: torch.Tensor
    q_md: torch.Tensor
    t_md: torch.Tensor
    kf_added: torch.Tensor
    n_corner_factors: torch.Tensor
    n_surf_factors: torch.Tensor


_KF_FIELDS = ("kf_q", "kf_t", "kf_stamp", "kf_travel", "kf_corner", "kf_corner_conf",
              "kf_corner_mask", "kf_surf", "kf_surf_conf", "kf_surf_mask")


def compact_keyframe_store(ms: MappingState, protect=None):
    """Thin the oldest half of the keyframe store (every other unprotected
    keyframe), keeping temporal order.  Returns (ms, keep [K] over old
    indices, new_of_old [K])."""
    K = ms.kf_q.shape[0]
    dev = ms.kf_q.device
    idx = torch.arange(K, device=dev)
    valid = idx < ms.kf_count
    old_half = idx < (ms.kf_count - K // 2)

    def every_other(elig):
        rank = torch.cumsum(elig.to(torch.int32), 0) - 1
        return elig & (torch.remainder(rank, 2) == 1)

    prot = torch.zeros(K, dtype=torch.bool, device=dev) if protect is None else protect
    evict1 = every_other(valid & old_half & ~prot)
    evict2 = every_other(valid & old_half)
    evict = torch.where(evict1.sum() > 0, evict1, evict2)
    keep = valid & ~evict
    new_of_old = (torch.cumsum(keep.to(torch.int32), 0) - 1).to(torch.int32)
    src = torch.argsort(torch.where(keep, idx, K + idx), stable=True)
    ms = ms.replace(
        **{f: getattr(ms, f)[src] for f in _KF_FIELDS},
        kf_count=keep.sum().to(torch.int32),
    )
    return ms, keep, new_of_old


def assemble_local_map(state: MappingState, t_center, cfg: SlamConfig):
    """The nearest keyframes within the search radius -> world-frame corner
    and surf maps, voxel-downsampled."""
    K = state.kf_q.shape[0]
    k_near = min(cfg.surrounding_keyframes, K)
    kf_valid = torch.arange(K, device=t_center.device) < state.kf_count
    d = m3.norm(state.kf_t - t_center[None, :])
    d = torch.where(kf_valid, d, torch.full_like(d, torch.inf))
    # lax.top_k(-d) order: nearest first, ties to the lower index
    d_sorted, sel = torch.sort(d, stable=True)
    d_sorted, sel = d_sorted[:k_near], sel[:k_near]
    sel_ok = d_sorted < cfg.surrounding_radius

    def gather(cloud, conf, mask):
        q = state.kf_q[sel]
        t = state.kf_t[sel]
        pts = m3.quat_rotate(q[:, None, :], cloud[sel]) + t[:, None, :]
        msk = mask[sel] & sel_ok[:, None]
        P = pts.shape[1]
        return pts.reshape(k_near * P, 3), conf[sel].reshape(k_near * P), msk.reshape(k_near * P)

    c_pts, _, c_mask = gather(state.kf_corner, state.kf_corner_conf, state.kf_corner_mask)
    s_pts, _, s_mask = gather(state.kf_surf, state.kf_surf_conf, state.kf_surf_mask)
    origin = torch.floor(t_center)
    cm_pts, cm_mask, _ = vh.voxel_downsample(c_pts - origin, c_mask, cfg.map_corner_voxel,
                                             cfg.max_map_points // 4, probes=cfg.hash_probes)
    sm_pts, sm_mask, _ = vh.voxel_downsample(s_pts - origin, s_mask, cfg.map_surf_voxel,
                                             cfg.max_map_points, probes=cfg.hash_probes)
    return cm_pts + origin, cm_mask, sm_pts + origin, sm_mask


class EdgeCorr(NamedTuple):
    pa: torch.Tensor          # [N, 3] line endpoint a (world)
    pb: torch.Tensor          # [N, 3]
    w: torch.Tensor           # [N] confidence (0 = invalid)


class PlaneCorr(NamedTuple):
    n: torch.Tensor           # [N, 3] unit normal
    d: torch.Tensor           # [N] offset
    w: torch.Tensor           # [N]


def edge_correspondences(pts_world, conf, mask, map_pts, map_mask, cfg: SlamConfig) -> EdgeCorr:
    """5-NN PCA line fit per corner point."""
    k = cfg.map_knn
    d2, idx = knn_ops.knn(pts_world, map_pts, map_mask, k)
    near = map_pts[idx.long()]                             # [N, k, 3]
    center = near.mean(1)
    dd = near - center[:, None, :]
    evals, evecs = eigh3x3(torch.einsum("nki,nkj->nij", dd, dd))
    unit = evecs[..., 2]
    is_line = evals[..., 2] > 3.0 * evals[..., 1]
    ok = mask & (d2[:, k - 1] < 1.0) & is_line
    return EdgeCorr(pa=center + 0.1 * unit, pb=center - 0.1 * unit,
                    w=torch.where(ok, conf, torch.zeros_like(conf)))


def _sum_k(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 (the k neighbours) term by term in index order: every
    row rounds the same whatever the batch around it (a reduction kernel
    may sum a row in an order set by its address, and then the robots of a
    fleet round apart, tools/lane_rounding.py)."""
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc


def _lstsq_qr(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Householder-QR least squares min ||A x - b|| for [N, k, m]
    (never the normal equations: κ² swamps float32 for plane patches far
    from the origin).  The sums over the k rows are ``_sum_k``'s."""
    N, k, m = A.shape
    R, y = A, b
    rows = torch.arange(k, device=A.device)
    for j in range(m):
        col = R[:, :, j]
        v = torch.where(rows[None, :] >= j, col, torch.zeros_like(col))
        alpha = torch.sqrt(_sum_k(v * v))
        sign = torch.where(col[:, j] >= 0, 1.0, -1.0).to(A.dtype)
        v = torch.cat([v[:, :j], (v[:, j] + sign * alpha)[:, None], v[:, j + 1:]], 1)
        coef = 2.0 / torch.clamp(_sum_k(v * v)[:, None], min=1e-30)
        proj = _sum_k(v[:, :, None] * R) * coef
        R = R - v[:, :, None] * proj[:, None, :]
        y = y - v * (_sum_k(v * y)[:, None] * coef)
    xs = [None] * m
    for i in reversed(range(m)):
        num = y[:, i]
        if i + 1 < m:
            acc = R[:, i, i + 1] * xs[i + 1]
            for j in range(i + 2, m):
                acc = acc + R[:, i, j] * xs[j]
            num = num - acc
        diag = R[:, i, i]
        xs[i] = num / torch.where(torch.abs(diag) > 1e-20, diag, torch.full_like(diag, 1e-20))
    return torch.stack(xs, 1)


def plane_correspondences(pts_world, conf, mask, map_pts, map_mask, cfg: SlamConfig) -> PlaneCorr:
    """5-NN plane fit solving A n = -1 by QR."""
    k = cfg.map_knn
    d2, idx = knn_ops.knn(pts_world, map_pts, map_mask, k)
    A = map_pts[idx.long()]                                # [N, k, 3]
    n_raw = _lstsq_qr(A, -torch.ones(A.shape[:2], dtype=A.dtype, device=A.device))
    nnorm = torch.clamp(m3.norm(n_raw), min=1e-9)
    d = 1.0 / nnorm
    n = n_raw / nnorm[:, None]
    fit_ok = (torch.abs(torch.einsum("nki,ni->nk", A, n) + d[:, None]) <= 0.2).all(1)
    ok = mask & (d2[:, k - 1] < 2.0) & fit_ok
    return PlaneCorr(n=n, d=d, w=torch.where(ok, conf, torch.zeros_like(conf)))


def _huber_weight(r2, delta: float = 0.1, loss: str = "huber"):
    """sqrt of Ceres HuberLoss rho'(s).  "huber" detaches the weight (the
    Ceres corrector does not differentiate it; differentiating it turns
    Huber into L1), "l1" lets the Jacobian see it."""
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    w = torch.sqrt(torch.where(r <= delta, torch.ones_like(r), delta / r))
    return w if loss == "l1" else w.detach()


def _edge_r(q, t, pts, corr: EdgeCorr):
    lp = m3.quat_rotate(q.reshape(1, 4), pts) + t.reshape(1, 3)
    nu = m3.cross(lp - corr.pa, lp - corr.pb)
    de = m3.norm(corr.pa - corr.pb, keepdim=True)
    return nu / torch.clamp(de, min=1e-9) * corr.w[:, None]


def _plane_r(q, t, pts, corr: PlaneCorr):
    pw = m3.quat_rotate(q.reshape(1, 4), pts) + t.reshape(1, 3)
    return ((pw * corr.n).sum(-1) + corr.d) * corr.w


def _edge_residuals(q, t, pts, corr: EdgeCorr, loss: str = "huber"):
    r = _edge_r(q, t, pts, corr)
    hw = _huber_weight((r * r).sum(-1), loss=loss)
    return (r * hw[:, None]).reshape(-1)


def _plane_residuals(q, t, pts, corr: PlaneCorr, loss: str = "huber"):
    r = _plane_r(q, t, pts, corr)
    return r * _huber_weight(r * r, loss=loss)


def _unpack(delta, c):
    """Tangent step -> the four poses, as [1, 4] / [1, 3] (intermediates
    stay 1-dim under forward-mode AD)."""
    d = delta[None, :]
    qc = m3.quat_normalize(m3.quat_mul(m3.quat_exp(d[:, 0:3]), c["q"]))
    qlc = m3.quat_normalize(m3.quat_mul(m3.quat_exp(d[:, 6:9]), c["ql"]))
    return qc, c["t"] + d[:, 3:6], qlc, c["tl"] + d[:, 9:12]


def _other_residuals(delta, c):
    """The NULL-loss RelativeR / PitchRoll / goable-ground factors, scaled by
    ``rep_scale`` (1 unless sp-sharded)."""
    qc, tc, qlc, tlc = _unpack(delta, c)
    w_imu, w_ground = c["w_imu"] * c["rep_scale"], c["w_ground"] * c["rep_scale"]
    ypr, ypr_l = c["imu_ypr"], c["imu_ypr_last"]
    return torch.cat([
        fac.relative_r_residual(qlc, qc, c["delta_q_imu"], c["imu_cov"]) * w_imu,
        fac.pitchroll_residual(qc, ypr[1], ypr[2], 0.02) * w_imu,
        fac.pitchroll_residual(qlc, ypr_l[1], ypr_l[2], 0.02) * w_imu,
        fac.ground_goable_residual(qc, tc, c["ql"], c["tl"], c["g_last"], c["g_cur"],
                                   c["q_w_curr_f"], 0.2) * w_ground,
        fac.ground_goable_residual(qlc, tlc, c["q_w_last2"], c["t_w_last2"], c["g_last2"],
                                   c["g_last"], c["q_w_curr_f2"], 0.2) * w_ground,
    ], -1).reshape(-1)


def _lidar_residuals(delta, c, loss: str):
    qc, tc, qlc, tlc = _unpack(delta, c)
    return torch.cat([
        _edge_residuals(qc, tc, c["corner"], c["ec"], loss),
        _edge_residuals(qlc, tlc, c["cornl"], c["ecl"], loss),
        _plane_residuals(qc, tc, c["surf"], c["pc"], loss),
        _plane_residuals(qlc, tlc, c["surfl"], c["pcl"], loss),
    ])


def _map_cost(delta, c, loss: str):
    """True robust cost 0.5·Σ rho(s) for the trust-region accept test:
    HuberLoss(0.1) on the lidar blocks' squared norms, identity on the
    NULL-loss factors."""
    qc, tc, qlc, tlc = _unpack(delta, c)
    s_lidar = torch.cat([
        (_edge_r(qc, tc, c["corner"], c["ec"]) ** 2).sum(-1),
        (_edge_r(qlc, tlc, c["cornl"], c["ecl"]) ** 2).sum(-1),
        _plane_r(qc, tc, c["surf"], c["pc"]) ** 2,
        _plane_r(qlc, tlc, c["surfl"], c["pcl"]) ** 2,
    ])
    ro = _other_residuals(delta, c)
    if loss == "l1":
        # the objective the l1-weighted GN direction descends (see the JAX module)
        rho = torch.where(s_lidar <= 0.01, s_lidar,
                          0.1 * torch.sqrt(torch.clamp(s_lidar, min=1e-30)))
    else:
        rho = fac.huber_rho(s_lidar)
    return 0.5 * (rho.sum() + (ro * ro).sum())


def scan_to_map_solve(
    q0, t0, ql0, tl0,
    corner_q, corner_q_conf, corner_q_mask,
    cornl_q, cornl_q_conf, cornl_q_mask,
    surf_q, surf_q_conf, surf_q_mask,
    surfl_q, surfl_q_conf, surfl_q_mask,
    cm_pts, cm_mask, sm_pts, sm_mask,
    delta_q_imu, imu_cov, w_imu, imu_ypr, imu_ypr_last,
    ground_last: GroundPlane, ground_cur: GroundPlane,
    ground_last2: GroundPlane, q_w_last2, t_w_last2,
    q_w_curr_f, q_w_curr_f2, w_ground,
    rep_scale, gn_axis, cfg: SlamConfig,
    debug: bool = False,
):
    """The two-outer-iteration joint (q, t, q_last, t_last) solve: per
    outer iteration the four clouds re-associate (frozen for the inner
    solve), then ``ceres_lm`` runs 6 iterations over the Huber(0.1) lidar
    factors plus the NULL-loss RelativeR / PitchRoll / goable-ground
    factors.  The current pose's ground factor snapshots the last pose from
    the carry.  Under ``gn_axis`` (sp point sharding) the four query
    clouds are this rank's blocks, the factors every rank repeats are
    scaled by ``rep_scale`` (rsqrt of the axis size) so that the summed H /
    g count them once, and H, g, the costs and the edge / plane counts are
    summed over the axis.  Returns ((q, t, ql, tl), (n_edge[outer],
    n_plane[outer]), dbg) with dbg (debug only) the per-outer (ec, ecl, pc,
    pcl, poses)."""
    loss = cfg.mapping_loss
    fixed = dict(
        corner=corner_q, cornl=cornl_q, surf=surf_q, surfl=surfl_q,
        delta_q_imu=delta_q_imu, imu_cov=imu_cov, w_imu=w_imu, imu_ypr=imu_ypr,
        imu_ypr_last=imu_ypr_last, rep_scale=rep_scale, g_last=fac.plane_params(ground_last),
        g_cur=fac.plane_params(ground_cur), g_last2=fac.plane_params(ground_last2),
        q_w_last2=q_w_last2, t_w_last2=t_w_last2, q_w_curr_f=q_w_curr_f,
        q_w_curr_f2=q_w_curr_f2, w_ground=w_ground,
    )

    def residuals(delta, c):
        return torch.cat([_lidar_residuals(delta, c, loss), _other_residuals(delta, c)])

    def cost(delta, c):
        return _map_cost(delta, c, loss)

    q, t, ql, tl = q0, t0, ql0, tl0
    n_edges, n_planes, dbg = [], [], []
    for _ in range(cfg.map_opt_iterations):
        pw_c = m3.quat_rotate(q[None, :], corner_q) + t[None, :]
        pw_cl = m3.quat_rotate(ql[None, :], cornl_q) + tl[None, :]
        pw_s = m3.quat_rotate(q[None, :], surf_q) + t[None, :]
        pw_sl = m3.quat_rotate(ql[None, :], surfl_q) + tl[None, :]
        ec = edge_correspondences(pw_c, corner_q_conf, corner_q_mask, cm_pts, cm_mask, cfg)
        ecl = edge_correspondences(pw_cl, cornl_q_conf, cornl_q_mask, cm_pts, cm_mask, cfg)
        pc = plane_correspondences(pw_s, surf_q_conf, surf_q_mask, sm_pts, sm_mask, cfg)
        pcl = plane_correspondences(pw_sl, surfl_q_conf, surfl_q_mask, sm_pts, sm_mask, cfg)
        consts = dict(fixed, q=q, t=t, ql=ql, tl=tl, ec=ec, ecl=ecl, pc=pc, pcl=pcl)

        P = None
        if cfg.degeneracy_thresh > 0:
            P, _ = fac.degeneracy_projection(
                lambda d, c: _lidar_residuals(d, c, loss), 12, cfg.degeneracy_thresh, consts,
                psum_axis=gn_axis)
        delta = fac.ceres_lm(residuals, cost, 12, iterations=6, consts=consts, project=P,
                             psum_axis=gn_axis)
        q = m3.quat_normalize(m3.quat_mul(m3.quat_exp(delta[0:3]), q))
        t = t + delta[3:6]
        ql = m3.quat_normalize(m3.quat_mul(m3.quat_exp(delta[6:9]), ql))
        tl = tl + delta[9:12]
        n_edge, n_plane = (ec.w > 0).sum(), (pc.w > 0).sum()
        if gn_axis is not None:
            n_edge, n_plane = psum(n_edge, gn_axis), psum(n_plane, gn_axis)
        n_edges.append(n_edge)
        n_planes.append(n_plane)
        if debug:
            dbg.append((ec, ecl, pc, pcl, (q, t, ql, tl)))
    return (q, t, ql, tl), (torch.stack(n_edges), torch.stack(n_planes)), (dbg if debug else None)


def mapping_step(state: MappingState, odo: OdometryOutput, corner_xyz, corner_conf,
                 corner_mask, surf_xyz, surf_conf, surf_mask, imu_ypr, stamp,
                 cfg: SlamConfig):
    dtype, dev = state.t_md.dtype, state.t_md.device
    ground_cur = odo.ground
    zero_i, one_i = torch.zeros_like(state.gflag), torch.ones_like(state.gflag)

    # ---- initial guess: odom pose lifted by map->odom ----
    q0 = m3.quat_normalize(m3.quat_mul(state.q_md, odo.q_w))
    t0 = state.t_md + m3.quat_rotate(state.q_md, odo.t_w)

    # ---- groundidentify (mapping-side machine) ----
    early = state.count <= 20
    q_lc = m3.quat_mul(m3.quat_conj(state.q_w_last), q0)
    t_lc = m3.quat_rotate(m3.quat_conj(state.q_w_last), t0 - state.t_w_last)
    gnorm_c = m3.quat_rotate(q_lc, ground_cur.normal)
    gdist_c = ground_cur.distance + torch.dot(gnorm_c, t_lc)
    gerr1 = m3.norm(state.ground_last.distance * state.ground_last.normal - gdist_c * gnorm_c)
    gerr2 = torch.abs(torch.dot(state.ground_last.v1, gnorm_c))
    d_ypr_deg = m3.mat_to_ypr(m3.quat_to_mat(odo.delta_q_imu)) * RAD2DEG
    change = (~early) & (gerr1 >= 0.02) & (gerr2 >= 0.02) & (torch.abs(d_ypr_deg[1]) > 0.5)
    gflag = torch.where(change, one_i, state.gflag)
    ccount = torch.where(change, zero_i, state.change_count)
    ccount = torch.where(gflag == 1, ccount + 1, ccount)
    resolve = (gflag == 1) & (ccount >= 25)
    now_ypr = m3.mat_to_ypr(m3.quat_to_mat(q0)) * RAD2DEG
    hist_ypr = m3.mat_to_ypr(m3.quat_to_mat(state.hist_q)) * RAD2DEG
    hvalid = torch.arange(HIST_CAP, device=dev) < state.hist_count
    pr = torch.sqrt((hist_ypr[:, 1] - now_ypr[1]) ** 2 + (hist_ypr[:, 2] - now_ypr[2]) ** 2)
    pr = torch.where(hvalid, pr, torch.full_like(pr, torch.inf))
    bi = torch.argmin(pr)
    found = pr[bi] < 6.0
    q_w_delta = torch.where(resolve, torch.where(found, state.hist_q[bi], q0), state.q_w_delta)
    push = early | (resolve & ~found)
    hist_q = torch.where(
        push,
        _set_row(state.hist_q, torch.remainder(state.hist_count, HIST_CAP),
                 torch.where(early, state.q_w_last, q0)),
        state.hist_q,
    )
    hist_count = torch.where(push, state.hist_count + 1, state.hist_count)
    gflag = torch.where(resolve, zero_i, gflag)
    q_w_curr_f = m3.quat_normalize(m3.quat_mul(m3.quat_conj(q_w_delta), state.q_w_last))
    q_w_curr_f2 = m3.quat_normalize(m3.quat_mul(m3.quat_conj(q_w_delta), state.q_w_last2))

    # ---- local map ----
    cm_pts, cm_mask, sm_pts, sm_mask = assemble_local_map(state, t0, cfg)
    do_opt = ((corner_mask.sum() > 10) & (surf_mask.sum() > 50)
              & (cm_mask.sum() > 10) & (sm_mask.sum() > 50))

    # ---- IMU factor covariances; both factor families off in localization
    # mode (map_update=False) ----
    imu_cov = torch.where(m3.norm(d_ypr_deg) > 0.6, 0.004, 0.4).to(dtype)
    w_imu = torch.tensor(1.0 if (cfg.use_imu and cfg.map_update) else 0.0, dtype=dtype, device=dev)
    ground_on = (
        cfg.use_ground & cfg.map_update & (gflag == 0) & (state.count > 20)
        & ground_cur.valid & state.ground_last.valid
    )
    w_ground = ground_on.to(dtype)

    # ---- sp point sharding: each rank associates and linearizes a block of
    # the query points of all four clouds, and the 12-dim H / g are summed
    # over the axis; factors every rank repeats are pre-scaled by
    # rsqrt(n_sp) so the sum counts them once.  The keyframe store below
    # keeps the full clouds, so the state stays the same on every rank ----
    queries = ((corner_xyz, corner_conf, corner_mask),
               (state.last_corner, state.last_corner_conf, state.last_corner_mask),
               (surf_xyz, surf_conf, surf_mask),
               (state.last_surf, state.last_surf_conf, state.last_surf_mask))
    n_sp = cfg.sp_shards if cfg.psum_axis is not None else 1
    if n_sp > 1:
        i_sp = axis_index(cfg.psum_axis)

        def shard_slice(cloud):
            per = cloud[0].shape[0] // n_sp
            return tuple(a[i_sp * per:(i_sp + 1) * per] for a in cloud)

        queries = tuple(shard_slice(c) for c in queries)
        rep_scale = torch.rsqrt(torch.tensor(float(n_sp), dtype=dtype, device=dev))
    else:
        rep_scale = torch.ones((), dtype=dtype, device=dev)
    gn_axis = cfg.psum_axis if n_sp > 1 else None

    # ---- two outer iterations: freeze correspondences, 6 LM steps ----
    (q_opt, t_opt, _, _), (ne, np_), _ = scan_to_map_solve(
        q0, t0, state.q_w_last, state.t_w_last,
        *queries[0], *queries[1], *queries[2], *queries[3],
        cm_pts, cm_mask, sm_pts, sm_mask,
        odo.delta_q_imu, imu_cov, w_imu, imu_ypr, state.imu_ypr_last,
        state.ground_last, ground_cur,
        state.ground_last2, state.q_w_last2, state.t_w_last2,
        q_w_curr_f, q_w_curr_f2, w_ground, rep_scale, gn_axis, cfg,
    )
    q_w = torch.where(do_opt, q_opt, q0)
    t_w = torch.where(do_opt, t_opt, t0)

    # ---- transformUpdate (map -> odom) ----
    q_md = m3.quat_normalize(m3.quat_mul(q_w, m3.quat_conj(odo.q_w)))
    t_md = t_w - m3.quat_rotate(q_md, odo.t_w)

    # ---- keyframe gating ----
    K = state.kf_q.shape[0]
    has_kf = state.kf_count > 0
    li = torch.clamp(state.kf_count - 1, 0, K - 1).long()
    d_pos = m3.norm(t_w - state.kf_t[li])
    ypr_l = m3.mat_to_ypr(m3.quat_to_mat(state.kf_q[li]))
    ypr_c = m3.mat_to_ypr(m3.quat_to_mat(q_w))
    d_ang = torch.abs(m3.wrap_angle(ypr_l - ypr_c)).max()
    add_kf = (~has_kf) | (d_pos > cfg.keyframe_dist) | (d_ang > cfg.keyframe_angle)
    add_kf = add_kf & cfg.map_update

    if (not cfg.loop_closure_enable) and cfg.inline_compaction:
        # long-session eviction when the store is full (host-side branch:
        # one device->host read per scan; the JAX package's lax.cond, so
        # under vmap the lanes that need it take the compacted store)
        full = add_kf & (state.kf_count >= K)
        if bool(any_lane(full)):
            state = tree_where(full, compact_keyframe_store(state)[0], state)
    # backstop: never write past capacity
    add_kf = add_kf & (state.kf_count < K)

    wi = torch.clamp(state.kf_count, 0, K - 1)
    C, S = cfg.max_kf_corner, cfg.max_kf_surf
    new_travel = state.travel_dist + torch.where(has_kf, d_pos, torch.zeros_like(d_pos))
    state_kf = state.replace(
        kf_q=_set_row(state.kf_q, wi, q_w),
        kf_t=_set_row(state.kf_t, wi, t_w),
        kf_stamp=_set_row(state.kf_stamp, wi, stamp.to(dtype)),
        kf_travel=_set_row(state.kf_travel, wi, new_travel),
        kf_corner=_set_row(state.kf_corner, wi, corner_xyz[:C]),
        kf_corner_conf=_set_row(state.kf_corner_conf, wi, corner_conf[:C]),
        kf_corner_mask=_set_row(state.kf_corner_mask, wi, corner_mask[:C]),
        kf_surf=_set_row(state.kf_surf, wi, surf_xyz[:S]),
        kf_surf_conf=_set_row(state.kf_surf_conf, wi, surf_conf[:S]),
        kf_surf_mask=_set_row(state.kf_surf_mask, wi, surf_mask[:S]),
        kf_count=state.kf_count + 1,
    )
    state = tree_where(add_kf, state_kf, state)

    # ---- shift the "last" frame state ----
    state = state.replace(
        q_md=q_md, t_md=t_md,
        q_w_last2=state.q_w_last, t_w_last2=state.t_w_last,
        q_w_last=q_w, t_w_last=t_w,
        last_corner=corner_xyz, last_corner_conf=corner_conf, last_corner_mask=corner_mask,
        last_surf=surf_xyz, last_surf_conf=surf_conf, last_surf_mask=surf_mask,
        ground_last2=state.ground_last, ground_last=ground_cur,
        gflag=gflag.to(torch.int32), change_count=ccount.to(torch.int32),
        q_w_delta=q_w_delta, hist_q=hist_q, hist_count=hist_count,
        imu_ypr_last=imu_ypr, count=state.count + 1,
        travel_dist=torch.where(add_kf, new_travel, state.travel_dist),
    )
    out = MappingOutput(q_w=q_w, t_w=t_w, q_md=q_md, t_md=t_md, kf_added=add_kf,
                        n_corner_factors=ne[-1], n_surf_factors=np_[-1])
    return state, out
