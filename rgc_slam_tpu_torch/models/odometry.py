"""Odometry front-end: the port of ``rgc_slam_tpu/models/odometry.py``.

IMU filtering and preintegration -> constant-velocity deskew -> VGICP
against the sliding world-frame submap -> factor-graph fusion (VGICP
rotation/translation + ground coplanarity + IMU rotation) -> ground-change
state machine -> pose composition with the xy/z split and the 95/5 IMU
pitch-roll pullback -> keyframe-gated submap ring update.  Both
``imu_cov_mode``s are ported: "reference" weighs the IMU rotation factor by
the reference's constants, "preint" by the propagated rotation variance of
``imu.preintegrate_full``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..config import SlamConfig
from ..utils.axes import axis_index, axis_size
from ..utils.graph import mark
from ..types import GroundPlane, ImuBatch, PointCloud, Struct, tree_where
from ..utils import math3d as m3
from ..ops import factors as fac
from ..ops import imu as imu_ops
from ..ops import registration as reg
from ..ops import voxelhash as vh
from ..ops.features import FeatureExtraction

HIST_CAP = 64
RAD2DEG = 57.29577951308232


@dataclass
class OdometryState(Struct):
    q_w: torch.Tensor
    t_w: torch.Tensor
    q_last: torch.Tensor
    t_last: torch.Tensor
    frame: torch.Tensor       # [] int32
    prev_stamp: torch.Tensor
    sub_xyz: torch.Tensor     # [S, P, 3]
    sub_cov: torch.Tensor     # [S, P, 3, 3]
    sub_mask: torch.Tensor    # [S, P]
    sub_q: torch.Tensor       # [S, 4]
    sub_t: torch.Tensor       # [S, 3]
    sub_count: torch.Tensor   # [] int32
    sub_next: torch.Tensor    # [] int32
    ground_last: GroundPlane
    gflag: torch.Tensor
    change_count: torch.Tensor
    q_w_delta: torch.Tensor
    hist_q: torch.Tensor      # [HIST_CAP, 4]
    hist_count: torch.Tensor
    imu_filter: imu_ops.ImuFilterState
    g_init: torch.Tensor
    q_body2world: torch.Tensor
    fitness: torch.Tensor

    @classmethod
    def init(cls, cfg: SlamConfig, device, dtype=torch.float32) -> "OdometryState":
        S, P = cfg.submap_window, cfg.max_source_points
        f = dict(dtype=dtype, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        qi = m3.quat_identity(device, dtype)
        return cls(
            q_w=qi.clone(), t_w=torch.zeros(3, **f), q_last=qi.clone(),
            t_last=torch.zeros(3, **f), frame=torch.tensor(0, **i32),
            prev_stamp=torch.tensor(0.0, **f),
            sub_xyz=torch.zeros((S, P, 3), **f), sub_cov=torch.zeros((S, P, 3, 3), **f),
            sub_mask=torch.zeros((S, P), dtype=torch.bool, device=device),
            sub_q=qi.repeat(S, 1), sub_t=torch.zeros((S, 3), **f),
            sub_count=torch.tensor(0, **i32), sub_next=torch.tensor(0, **i32),
            ground_last=GroundPlane.default(cfg.lidar_height, device, dtype),
            gflag=torch.tensor(0, **i32), change_count=torch.tensor(0, **i32),
            q_w_delta=qi.clone(), hist_q=qi.repeat(HIST_CAP, 1),
            hist_count=torch.tensor(0, **i32),
            imu_filter=imu_ops.ImuFilterState.init(device, dtype),
            g_init=torch.tensor([0.0, 0.0, 9.81], **f), q_body2world=qi.clone(),
            fitness=torch.tensor(0.0, **f),
        )


class OdometryOutput(NamedTuple):
    q_w: torch.Tensor
    t_w: torch.Tensor
    q_rel: torch.Tensor
    t_rel: torch.Tensor
    delta_q_imu: torch.Tensor
    fitness: torch.Tensor
    n_corr: torch.Tensor
    deskewed_full: PointCloud
    deskewed_sharp_xyz: torch.Tensor
    deskewed_flat_xyz: torch.Tensor
    ground: GroundPlane
    gflag: torch.Tensor
    lm_iters: Optional[torch.Tensor] = None   # int32 [3]: VGICP LM outer, inner, bodies run


def deskew_points(xyz, rel_time, q_rel, t_rel):
    """Constant-velocity deskew to the end-of-scan frame:
    s = 1 - rel_time;  p' = slerp(I, q_rel^-1, s) (p - s t_rel)."""
    s = 1.0 - rel_time
    n = xyz.shape[0]
    qs = m3.quat_slerp(
        m3.quat_identity(xyz.device, xyz.dtype).expand(n, 4),
        m3.quat_conj(q_rel).expand(n, 4),
        s,
    )
    return m3.quat_rotate(qs, xyz - s[:, None] * t_rel[None, :])


def _submap_target(state: OdometryState, cfg: SlamConfig, origin):
    """Concatenated submap ring (origin-shifted), downsampled at the target
    voxel size, then the Gaussian voxel map at the VGICP resolution."""
    S, P = state.sub_xyz.shape[0], state.sub_xyz.shape[1]
    pts = (state.sub_xyz - origin[None, None, :]).reshape(S * P, 3)
    ds_pts, ds_mask, (ds_cov,) = vh.voxel_downsample(
        pts, state.sub_mask.reshape(S * P), cfg.target_voxel_size, cfg.max_voxels,
        extras=(state.sub_cov.reshape(S * P, 3, 3),), probes=cfg.hash_probes,
    )
    return vh.build_gaussian_voxelmap(ds_pts, ds_cov, ds_mask, cfg.vgicp_resolution,
                                      cfg.max_voxels, probes=cfg.hash_probes)


def _set_row(a: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``a.at[i].set(v)`` with a device index (no host sync)."""
    return a.index_put((i.long().reshape(1),), v.unsqueeze(0))


def _insert_submap(state: OdometryState, xyz_w, cov_w, mask, q, t) -> OdometryState:
    i = state.sub_next
    S = state.sub_xyz.shape[0]
    return state.replace(
        sub_xyz=_set_row(state.sub_xyz, i, xyz_w),
        sub_cov=_set_row(state.sub_cov, i, cov_w),
        sub_mask=_set_row(state.sub_mask, i, mask),
        sub_q=_set_row(state.sub_q, i, q),
        sub_t=_set_row(state.sub_t, i, t),
        sub_count=torch.clamp(state.sub_count + 1, max=S),
        sub_next=torch.remainder(state.sub_next + 1, S).to(torch.int32),
    )


def fusion_solve(q_l, t_l, fitness, g_last, ground_cur, q_w_curr_f, delta_q_imu, imu_cov,
                 w_imu, w_ground):
    """The odometer's (q, t) factor-fusion solve: DeltaR(q_l, fitness) +
    [ground] DeltaP(t_l, fitness/10) + Ground_DeltaFactor(0.2) + [imu]
    DeltaR(delta_q_imu, imu_cov), all NULL-loss, by ``ceres_lm`` with the
    plain least-squares cost."""

    consts = dict(
        q_l=q_l, t_l=t_l, fitness=fitness, g_last=fac.plane_params(g_last),
        g_cur=fac.plane_params(ground_cur), q_w_curr_f=q_w_curr_f,
        delta_q_imu=delta_q_imu, imu_cov=imu_cov, w_imu=w_imu, w_ground=w_ground,
    )

    def residuals(delta, c):
        d = delta[None, :]                  # [1, 6]: keep intermediates 1-dim
        q = m3.quat_normalize(m3.quat_mul(m3.quat_exp(d[:, :3]), c["q_l"]))
        t = c["t_l"] + d[:, 3:]
        return torch.cat([
            fac.delta_r_residual(q, c["q_l"], c["fitness"]),
            fac.delta_p_residual(t, c["t_l"], c["fitness"] / 10.0) * c["w_ground"],
            fac.ground_delta_residual(q, t, c["g_last"], c["g_cur"], c["q_w_curr_f"], 0.2)
            * c["w_ground"],
            fac.delta_r_residual(q, c["delta_q_imu"], c["imu_cov"]) * c["w_imu"],
        ], -1).reshape(-1)

    def cost(delta, c):
        r = residuals(delta, c)
        return 0.5 * (r * r).sum()

    delta = fac.ceres_lm(residuals, cost, 6, iterations=6, consts=consts)
    q_fused = m3.quat_normalize(m3.quat_mul(m3.quat_exp(delta[:3]), q_l))
    return q_fused, t_l + delta[3:]


def odometry_step(state: OdometryState, fx: FeatureExtraction, imu: ImuBatch, stamp,
                  cfg: SlamConfig):
    """One scan through the odometry front-end.  Returns (state, output)."""
    dtype, dev = state.t_w.dtype, state.t_w.device
    ground_cur = fx.ground
    qi = m3.quat_identity(dev, dtype)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)

    # ---- IMU: attitude filter + preintegration over the interval ----
    imu_state = imu_ops.complementary_filter_scan(state.imu_filter, imu, cfg.gravity)
    if cfg.imu_cov_mode == "preint":
        # full 15-dim propagation: the rotation block's variance weighs the
        # IMU rotation factor below instead of the reference's constants
        full = imu_ops.preintegrate_full(
            imu, state.prev_stamp, stamp, state.imu_filter.ba, state.imu_filter.bg,
            acc_n=cfg.imu_acc_n, gyr_n=cfg.imu_gyr_n, acc_w=cfg.imu_acc_w, gyr_w=cfg.imu_gyr_w,
        )
        preint = imu_ops.Preintegration(delta_q=full.delta_q, delta_p=full.delta_p,
                                        delta_v=full.delta_v, sum_dt=full.sum_dt)
        imu_rot_var = torch.diagonal(full.cov[3:6, 3:6]).sum() / 3.0
    else:
        preint = imu_ops.preintegrate(imu, state.prev_stamp, stamp, state.imu_filter.ba,
                                      state.imu_filter.bg)
        imu_rot_var = None
    delta_q_imu = preint.delta_q if cfg.use_imu else qi
    frame_dt = torch.clamp(stamp - state.prev_stamp, min=1e-3).to(dtype)

    q_pred = delta_q_imu if cfg.use_imu else state.q_last
    t_pred = state.t_last

    # ---- deskew (full + features) with the predicted motion ----
    full_xyz = deskew_points(fx.full.xyz, fx.full.rel_time, q_pred, t_pred)
    sharp_xyz = deskew_points(fx.sharp.xyz, fx.sharp.rel_time, q_pred, t_pred)
    flat_xyz = deskew_points(fx.flat.xyz, fx.flat.rel_time, q_pred, t_pred)
    full = fx.full.replace(xyz=full_xyz)

    # ---- source downsample with covariances ----
    src, src_mask, (src_cov,) = vh.voxel_downsample(
        full_xyz, full.mask, cfg.source_voxel_size, cfg.max_source_points,
        extras=(fx.normals_cov,), probes=cfg.hash_probes,
    )
    if cfg.psum_axis is not None and cfg.sp_shards > 1:
        # point-sharded registration, block slice: each rank looks up and
        # linearizes its n/sp_shards rows of the source, and lm_register
        # sums the 6x6 H / b / cost over the axis (the submap insertion
        # below takes the full arrays, so the state stays the same on
        # every rank)
        per = src.shape[0] // cfg.sp_shards
        start = axis_index(cfg.psum_axis) * per
        reg_src, reg_cov, reg_mask = (a[start:start + per] for a in (src, src_cov, src_mask))
    elif cfg.psum_axis is not None:
        # stride-masked fallback (sp_shards unset): the sums are right, but
        # every rank still pays the full lookup
        shard, n_shards = axis_index(cfg.psum_axis), axis_size(cfg.psum_axis)
        reg_src, reg_cov = src, src_cov
        reg_mask = src_mask & (torch.arange(src.shape[0], device=dev) % n_shards == shard)
    else:
        reg_src, reg_cov, reg_mask = src, src_cov, src_mask

    # ---- VGICP against the submap (world frame, origin-anchored) ----
    origin = torch.floor(state.t_w)
    vm = _submap_target(state, cfg, origin)
    q_guess = m3.quat_normalize(m3.quat_mul(state.q_w, q_pred))
    t_guess = state.t_w + m3.quat_rotate(state.q_w, t_pred) - origin
    mark("odometry_pre")
    res = reg.lm_register(reg_src, reg_cov, reg_mask, vm, q_guess, t_guess, cfg)
    mark("vgicp_lm")
    have_map = state.sub_count > 0
    q_new_w = torch.where(have_map, res.q, q_guess)
    t_new_w = torch.where(have_map, res.t, t_guess) + origin
    fitness = torch.where(have_map, res.fitness, torch.ones((), dtype=dtype, device=dev))
    fitness = torch.clamp(fitness, 1e-4, 1.0)

    # relative motion from VGICP (the lidar measurement)
    q_l = m3.quat_normalize(m3.quat_mul(m3.quat_conj(state.q_w), q_new_w))
    t_l = m3.quat_rotate(m3.quat_conj(state.q_w), t_new_w - state.t_w)

    # ---- ground-change detection ----
    g_last = state.ground_last
    norm_cur_l = m3.quat_rotate(q_l, ground_cur.normal)
    dist_cur_l = ground_cur.distance + torch.dot(norm_cur_l, t_l)
    gerr1 = m3.norm(g_last.distance * g_last.normal - dist_cur_l * norm_cur_l)
    gerr2 = torch.abs(torch.dot(g_last.v1, norm_cur_l))
    d_ypr_deg = m3.mat_to_ypr(m3.quat_to_mat(delta_q_imu)) * RAD2DEG
    change_detected = (gerr1 >= 0.02) & (gerr2 >= 0.02) & (torch.abs(d_ypr_deg[1]) > 0.5)

    one_i, zero_i = torch.ones_like(state.gflag), torch.zeros_like(state.gflag)
    gflag = torch.where(change_detected, one_i, state.gflag)
    change_count = torch.where(change_detected, zero_i, state.change_count)
    counting = gflag == 1
    change_count = torch.where(counting, change_count + 1, change_count)
    resolve = counting & (change_count >= 25)

    # historical plane re-anchor: best pitch/roll match over history
    now_ypr = m3.mat_to_ypr(m3.quat_to_mat(state.q_w)) * RAD2DEG
    hist_ypr = m3.mat_to_ypr(m3.quat_to_mat(state.hist_q)) * RAD2DEG
    hist_valid = torch.arange(HIST_CAP, device=dev) < state.hist_count
    pr_err = torch.sqrt((hist_ypr[:, 1] - now_ypr[1]) ** 2 + (hist_ypr[:, 2] - now_ypr[2]) ** 2)
    pr_err = torch.where(hist_valid, pr_err, torch.full_like(pr_err, torch.inf))
    best = torch.argmin(pr_err)
    found = m3.take(pr_err, best) < 4.0
    q_w_delta = torch.where(resolve, torch.where(found, m3.take(state.hist_q, best), state.q_w),
                            state.q_w_delta)
    push_hist = resolve & ~found
    hist_q = torch.where(push_hist,
                         _set_row(state.hist_q, torch.remainder(state.hist_count, HIST_CAP),
                                  state.q_w),
                         state.hist_q)
    hist_count = torch.where(push_hist, state.hist_count + 1, state.hist_count)
    gflag = torch.where(resolve, zero_i, gflag)

    q_w_curr_f = m3.quat_normalize(m3.quat_mul(m3.quat_conj(q_w_delta), state.q_w))

    # ---- factor fusion over (q, t) ----
    ground_active = cfg.use_ground & (gflag == 0) & ground_cur.valid & g_last.valid
    d_ypr_norm = m3.norm(d_ypr_deg)
    if imu_rot_var is not None:
        imu_cov = torch.clamp(imu_rot_var, 1e-4, 1.0)
    else:
        imu_cov = torch.where(d_ypr_norm > 0.6, torch.full_like(fitness, cfg.imu_cov_fast),
                              1.0 - fitness)
        imu_cov = torch.clamp(imu_cov, min=1e-4)
    w_ground = ground_active.to(dtype)
    w_imu = torch.full((), 1.0 if cfg.use_imu else 0.0, dtype=dtype, device=dev)
    q_fused, t_fused = fusion_solve(q_l, t_l, fitness, g_last, ground_cur, q_w_curr_f,
                                    delta_q_imu, imu_cov, w_imu, w_ground)
    # without the ground factor the reference keeps the raw VGICP translation
    t_fused = torch.where(ground_active, t_fused, t_l)

    # ---- pose composition: xy from VGICP, z from the fused solve ----
    t_tmp_f = m3.quat_rotate(state.q_w, t_fused)
    t_tmp_l = m3.quat_rotate(state.q_w, t_l)
    t_tmp = torch.stack([t_tmp_l[0], t_tmp_l[1], t_tmp_f[2]])
    t_rel = m3.quat_rotate(m3.quat_conj(state.q_w), t_tmp)
    t_w = state.t_w + m3.quat_rotate(state.q_w, t_rel)
    q_w = m3.quat_normalize(m3.quat_mul(state.q_w, q_fused))

    # ---- 95/5 pitch-roll pullback to the IMU gravity direction ----
    if cfg.use_imu:
        ypr_w = m3.mat_to_ypr(m3.quat_to_mat(q_w))
        ypr_i = m3.mat_to_ypr(imu_state.rwi())
        q_w = m3.ypr_to_quat(torch.stack([
            ypr_w[0], 0.95 * ypr_w[1] + 0.05 * ypr_i[1], 0.95 * ypr_w[2] + 0.05 * ypr_i[2]
        ]))

    # ---- gravity initialization on the first moving frame ----
    do_grav = (state.frame == 1) & cfg.use_imu
    v_ij = t_rel / frame_dt
    t_ij = torch.where(m3.norm(v_ij) < 0.1, zero3, t_rel)
    g_new, q_b2w = imu_ops.gravity_init(preint, state.q_w, t_ij, frame_dt, cfg.gravity)
    g_init = torch.where(do_grav, g_new, state.g_init)
    q_body2world = torch.where(do_grav, q_b2w, state.q_body2world)

    # ---- consume the init: re-align the odometry world frame so +z
    # opposes the solved gravity (pose, submap store, g_init and the
    # ground-machine attitude snapshots rotate together) ----
    if cfg.use_imu:
        qg = torch.where(do_grav, q_b2w, qi)
        Rg = m3.quat_to_mat(qg)
        q_w = m3.quat_normalize(m3.quat_mul(qg, q_w))
        t_w = m3.quat_rotate(qg, t_w)
        g_init = m3.quat_rotate(qg, g_init)
        q_w_delta = m3.quat_normalize(m3.quat_mul(qg, q_w_delta))
        hist_q = m3.quat_normalize(m3.quat_mul(qg[None, :], hist_q))
        state = state.replace(
            sub_xyz=torch.einsum("ij,snj->sni", Rg, state.sub_xyz),
            sub_cov=torch.einsum("ij,snjk,lk->snil", Rg, state.sub_cov, Rg),
            sub_q=m3.quat_normalize(m3.quat_mul(qg[None, :], state.sub_q)),
            sub_t=torch.einsum("ij,sj->si", Rg, state.sub_t),
        )

    # ---- first frame: attitude from the IMU filter + the initial pose ----
    is_first = state.frame == 0
    if cfg.use_imu:
        ypr0 = m3.mat_to_ypr(imu_state.rwi().to(dtype))
        q_first = m3.ypr_to_quat(torch.stack([ypr0[0] + cfg.init_yaw, ypr0[1], ypr0[2]]))
    else:
        q_first = m3.ypr_to_quat(m3.const((cfg.init_yaw, 0.0, 0.0), dtype, dev))
    t_first = m3.const((cfg.init_x, cfg.init_y, cfg.init_z), dtype, dev)
    q_w = torch.where(is_first, q_first, q_w)
    t_w = torch.where(is_first, t_first, t_w)
    q_rel_out = torch.where(is_first, qi, q_fused)
    t_rel_out = torch.where(is_first, zero3, t_rel)

    # ---- submap insertion (keyframe-gated) ----
    S = state.sub_xyz.shape[0]
    last_i = torch.remainder(state.sub_next - 1, S)
    ypr_last = m3.mat_to_ypr(m3.quat_to_mat(m3.take(state.sub_q, last_i)))
    ypr_cur = m3.mat_to_ypr(m3.quat_to_mat(q_w))
    d_ang = torch.abs(m3.wrap_angle(ypr_last - ypr_cur))
    d_pos = m3.norm(m3.take(state.sub_t, last_i) - t_w)
    want_insert = (
        is_first | (state.sub_count < S) | (d_pos > cfg.keyframe_dist)
        | (d_ang > cfg.keyframe_angle).any()
    )
    xyz_w = m3.quat_rotate(q_w[None, :], src) + t_w[None, :]
    R_w = m3.quat_to_mat(q_w)
    cov_w = torch.einsum("ij,njk,lk->nil", R_w, src_cov, R_w)
    state = tree_where(want_insert, _insert_submap(state, xyz_w, cov_w, src_mask, q_w, t_w),
                       state)

    state = state.replace(
        q_w=q_w, t_w=t_w, q_last=q_rel_out, t_last=t_rel_out,
        frame=state.frame + 1, prev_stamp=stamp.to(dtype), ground_last=ground_cur,
        gflag=gflag.to(torch.int32), change_count=change_count.to(torch.int32),
        q_w_delta=q_w_delta, hist_q=hist_q, hist_count=hist_count,
        imu_filter=imu_state, g_init=g_init, q_body2world=q_body2world, fitness=fitness,
    )
    out = OdometryOutput(
        q_w=q_w, t_w=t_w, q_rel=q_rel_out, t_rel=t_rel_out, delta_q_imu=delta_q_imu,
        fitness=fitness, n_corr=res.n_corr, deskewed_full=full,
        deskewed_sharp_xyz=sharp_xyz, deskewed_flat_xyz=flat_xyz, ground=ground_cur,
        gflag=gflag.to(torch.int32), lm_iters=torch.stack([res.iterations, res.inner, res.bodies]),
    )
    return state, out
