"""IMU front-end: the port of ``rgc_slam_tpu/ops/imu.py``.

Median filters, the complementary attitude filter, static-bias estimation,
quaternion + midpoint preintegration and gravity initialization.  The JAX
package's ``lax.scan`` recurrences become Python loops over the padded
IMU window (64 samples); padded samples are masked out with ``where``
exactly as the scan body does.  ``preintegrate_full``'s per-sample
linearization is ``torch.func.jacfwd`` under ``vmap`` over the samples, as
the JAX function's is ``jax.jacfwd`` under ``jax.vmap``;
``bias_corrected_delta`` applies its bias Jacobians to first order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..types import ImuBatch, Struct
from ..utils import math3d as m3

MED_WIN = 41
MED_WIN_X = 201
WARM_DROP = 100
WARM_CAP = 256
WARM_TRIM = 32
RAD2DEG = 57.29577951308232


@dataclass
class ImuFilterState(Struct):
    """Persistent complementary-filter + median-filter state."""

    roll: torch.Tensor
    pitch: torch.Tensor
    yaw: torch.Tensor
    count: torch.Tensor       # [] int32
    last_t: torch.Tensor
    ba: torch.Tensor          # [3]
    bg: torch.Tensor          # [3]
    bufx: torch.Tensor        # [MED_WIN_X]
    bufy: torch.Tensor        # [MED_WIN]
    bufz: torch.Tensor        # [MED_WIN]
    warm_acc: torch.Tensor    # [WARM_CAP, 3]
    warm_gyr: torch.Tensor    # [WARM_CAP, 3]
    warm_n: torch.Tensor      # [] int32
    bias_ready: torch.Tensor  # [] bool

    @classmethod
    def init(cls, device, dtype=torch.float32) -> "ImuFilterState":
        f = dict(dtype=dtype, device=device)
        return cls(
            roll=torch.tensor(0.0, **f), pitch=torch.tensor(0.0, **f),
            yaw=torch.tensor(0.0, **f),
            count=torch.tensor(0, dtype=torch.int32, device=device),
            last_t=torch.tensor(-1.0, **f),
            ba=torch.zeros(3, **f), bg=torch.zeros(3, **f),
            bufx=torch.zeros(MED_WIN_X, **f), bufy=torch.zeros(MED_WIN, **f),
            bufz=torch.zeros(MED_WIN, **f),
            warm_acc=torch.zeros((WARM_CAP, 3), **f),
            warm_gyr=torch.zeros((WARM_CAP, 3), **f),
            warm_n=torch.tensor(0, dtype=torch.int32, device=device),
            bias_ready=torch.tensor(False, device=device),
        )

    def rwi(self) -> torch.Tensor:
        """World-from-IMU rotation from the filter attitude."""
        return m3.ypr_to_mat(torch.stack([self.yaw, self.pitch, self.roll]))


def _median_update(buf: torch.Tensor, count: torch.Tensor, x: torch.Tensor):
    """Push x into the ring buffer; return (new_buf, median of the filled part)."""
    w = buf.shape[0]
    pos = torch.remainder(count, w).long()
    buf = buf.index_put((pos,), x)
    filled = torch.clamp(count + 1, max=w)
    idx = torch.arange(w, device=buf.device)
    masked = torch.where(idx < filled, buf, torch.full_like(buf, torch.inf))
    srt = torch.sort(masked).values
    return buf, m3.take(srt, torch.div(filled - 1, 2, rounding_mode="floor"))


def _euler_rates_matrix(roll, pitch):
    """Body rates -> euler-angle rates."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cpc = torch.clamp(cp, min=1e-6)
    tp = sp / cpc
    one, zero = torch.ones_like(cr), torch.zeros_like(cr)
    return torch.stack([
        torch.stack([one, sr * tp, cr * tp]),
        torch.stack([zero, cr, -sr]),
        torch.stack([zero, sr / cpc, cr / cpc]),
    ])


def _filter_sample(s: ImuFilterState, t, acc, gyr, valid, g_vec) -> ImuFilterState:
    """One complementary-filter update (the JAX scan body); ``g_vec`` is
    the gravity vector (0, 0, g)."""
    dt = torch.where((s.last_t > 0) & (t > s.last_t), t - s.last_t,
                     torch.full_like(t, 0.005))
    bufx, ax = _median_update(s.bufx, s.count, acc[0])
    bufy, ay = _median_update(s.bufy, s.count, acc[1])
    bufz, az = _median_update(s.bufz, s.count, acc[2])

    # the handler increments count BEFORE the filter runs
    cnt = s.count + 1
    k = torch.where(cnt < 300, 0.9, 0.002).to(t.dtype)
    gx, gy, gz = gyr[0] - s.bg[0], gyr[1] - s.bg[1], gyr[2] - s.bg[2]
    gz = torch.where(torch.abs(gz * RAD2DEG) < 0.2, torch.zeros_like(gz), gz)

    # acceleration gating toward the expected gravity direction
    Rimu = m3.ypr_to_mat(torch.stack([torch.zeros_like(s.pitch), s.pitch, s.roll]))
    acc_exp = Rimu @ g_vec
    ratio_x = torch.abs(acc_exp[0]) / torch.clamp(torch.abs(ax), min=1e-6)
    ax = torch.where((cnt > 300) & (torch.abs(ax) > 0.3) & (ratio_x < 0.8),
                     ratio_x * ax + (1 - ratio_x) * acc_exp[0], ax)
    ratio_y = torch.abs(acc_exp[1]) / torch.clamp(torch.abs(ay), min=1e-6)
    ay = torch.where((cnt > 300) & (torch.abs(ay) > 0.3) & (ratio_y < 0.8),
                     ratio_y * ay + (1 - ratio_y) * acc_exp[1], ay)

    roll_acc = torch.atan2(ay, az)
    pitch_acc = -torch.atan2(ax, az)
    er = _euler_rates_matrix(s.roll, s.pitch) @ torch.stack([gx, gy, gz])

    roll = k * roll_acc + (1.0 - k) * (s.roll + er[0] * dt)
    pitch = k * pitch_acc + (1.0 - k) * (s.pitch + er[1] * dt)
    yaw = s.yaw + er[2] / 0.9998 * dt

    # damp attitude updates during fast rotation (threshold on the euler
    # yaw rate, as the reference converts gz in place before the test)
    fast = torch.abs(er[2] * RAD2DEG) > 5.0
    low = 0.005
    roll = torch.where(fast, low * roll + (1 - low) * s.roll, roll)
    pitch = torch.where(fast, low * pitch + (1 - low) * s.pitch, pitch)

    collect = valid & (s.count >= WARM_DROP) & (s.warm_n < WARM_CAP) & ~s.bias_ready
    wpos = torch.clamp(s.warm_n, 0, WARM_CAP - 1).long()
    warm_acc = torch.where(collect, s.warm_acc.index_put((wpos,), acc), s.warm_acc)
    warm_gyr = torch.where(collect, s.warm_gyr.index_put((wpos,), gyr), s.warm_gyr)

    return s.replace(
        roll=torch.where(valid, m3.wrap_rollpitch(roll), s.roll),
        pitch=torch.where(valid, m3.wrap_rollpitch(pitch), s.pitch),
        yaw=torch.where(valid, m3.wrap_angle(yaw), s.yaw),
        count=torch.where(valid, s.count + 1, s.count),
        last_t=torch.where(valid, t, s.last_t),
        bufx=torch.where(valid, bufx, s.bufx),
        bufy=torch.where(valid, bufy, s.bufy),
        bufz=torch.where(valid, bufz, s.bufz),
        warm_acc=warm_acc,
        warm_gyr=warm_gyr,
        warm_n=torch.where(collect, s.warm_n + 1, s.warm_n),
    )


def complementary_filter_scan(state: ImuFilterState, imu: ImuBatch,
                              gravity: float = 9.81) -> ImuFilterState:
    """Run the complementary filter over one padded IMU window, then apply
    the startup bias/attitude initialization once the warm-up window fills
    (only if at least half of it tested static)."""
    out = state
    g_vec = m3.const((0.0, 0.0, gravity), imu.t.dtype, imu.t.device)
    for m in range(imu.t.shape[0]):
        out = _filter_sample(out, imu.t[m], imu.acc[m], imu.gyr[m], imu.mask[m], g_vec)

    ready_now = (~out.bias_ready) & (out.warm_n >= WARM_CAP)
    all_mask = torch.ones(WARM_CAP, dtype=torch.bool, device=imu.t.device)
    ba_mean, bg_mean, roll_i, pitch_i = estimate_static_bias(
        out.warm_acc, out.warm_gyr, all_mask, trim=WARM_TRIM, gravity=gravity
    )
    n_static = check_static(out.warm_acc, out.warm_gyr, gravity).sum()
    apply = ready_now & (n_static >= WARM_CAP // 2)
    ba_norm = m3.norm(ba_mean)
    ba_true = ba_mean * (1.0 - gravity / torch.clamp(ba_norm, min=1e-6))
    return out.replace(
        ba=torch.where(apply, ba_true, out.ba),
        bg=torch.where(apply, bg_mean, out.bg),
        roll=torch.where(apply, roll_i, out.roll),
        pitch=torch.where(apply, pitch_i, out.pitch),
        bias_ready=out.bias_ready | ready_now,
    )


def check_static(acc: torch.Tensor, gyr: torch.Tensor, gravity: float = 9.81):
    """Per-sample stationarity: |acc|-g within 0.5 m/s^2, every gyro axis
    below 0.05 rad/s."""
    acc_ok = torch.abs(m3.norm(acc) - gravity) <= 0.5
    gyr_ok = (torch.abs(gyr) <= 0.05).all(-1)
    return acc_ok & gyr_ok


def estimate_static_bias(acc, gyr, mask, trim: int = 50, gravity: float = 9.81):
    """Trimmed-mean static bias and the initial roll/pitch from gravity.
    Returns (ba [3], bg [3], roll_init, pitch_init)."""
    ok = mask & check_static(acc, gyr, gravity)
    n_ok = ok.sum()

    def trimmed_mean(x):
        big = torch.where(ok[:, None], x, torch.full_like(x, torch.inf))
        srt = torch.sort(big, dim=0).values
        n_use = torch.clamp(n_ok - 2 * trim, min=1)
        lo = torch.clamp(torch.clamp(n_ok - 1, min=0), max=trim)
        idx = torch.arange(x.shape[0], device=x.device)[:, None]
        use = (idx >= lo) & (idx < lo + n_use)
        return torch.where(use & torch.isfinite(srt), srt, torch.zeros_like(srt)).sum(0) / n_use

    ba = trimmed_mean(acc)
    bg = trimmed_mean(gyr)
    roll_init = torch.atan2(ba[1], ba[2])
    pitch_init = -torch.atan2(ba[0], torch.sqrt(ba[1] ** 2 + ba[2] ** 2))
    return ba, bg, roll_init, pitch_init


class Preintegration(NamedTuple):
    """Δ quantities over one scan interval."""

    delta_q: torch.Tensor     # [4]
    delta_p: torch.Tensor     # [3]
    delta_v: torch.Tensor     # [3]
    sum_dt: torch.Tensor      # []


def _midpoint(q, p, v, ba, bg, a0, a1, g0, g1, dt_i):
    """One midpoint step of the preintegrated (q, p, v)."""
    un_gyr = 0.5 * (g0 + g1) - bg
    dq = m3.quat_normalize(torch.cat([torch.ones_like(un_gyr[:1]), un_gyr * dt_i / 2.0]))
    q_new = m3.quat_normalize(m3.quat_mul(q, dq))
    un_acc = 0.5 * (m3.quat_rotate(q, a0 - ba) + m3.quat_rotate(q_new, a1 - ba))
    p_new = p + v * dt_i + 0.5 * un_acc * dt_i * dt_i
    v_new = v + un_acc * dt_i
    return q_new, p_new, v_new


def _midpoint_pass(imu: ImuBatch, t0, ba, bg):
    """The midpoint recurrence over the padded window, the first sample's dt
    measured from t0: (Preintegration, the per-sample inputs (dt, acc0,
    gyr0), and the (q, p, v) each sample starts from)."""
    dev, dtype = imu.t.device, imu.acc.dtype
    prev_t = torch.cat([m3.const((-1.0,), imu.t.dtype, dev), imu.t[:-1]])
    prev_valid = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), imu.mask[:-1]])
    dt = torch.where(prev_valid, imu.t - prev_t, imu.t - t0)
    dt = torch.where(imu.mask, torch.clamp(dt, min=0.0), torch.zeros_like(dt))
    acc0 = torch.where(prev_valid[:, None], torch.cat([imu.acc[:1], imu.acc[:-1]], 0), imu.acc)
    gyr0 = torch.where(prev_valid[:, None], torch.cat([imu.gyr[:1], imu.gyr[:-1]], 0), imu.gyr)

    q = m3.quat_identity(dev, dtype)
    p = torch.zeros(3, dtype=dtype, device=dev)
    v = torch.zeros(3, dtype=dtype, device=dev)
    sdt = torch.zeros((), dtype=dtype, device=dev)
    starts = []
    for m in range(imu.t.shape[0]):
        starts.append((q, p, v))
        q_new, p_new, v_new = _midpoint(q, p, v, ba, bg, acc0[m], imu.acc[m], gyr0[m],
                                        imu.gyr[m], dt[m])
        valid = imu.mask[m]
        q = torch.where(valid, q_new, q)
        p = torch.where(valid, p_new, p)
        v = torch.where(valid, v_new, v)
        sdt = sdt + torch.where(valid, dt[m], torch.zeros_like(dt[m]))
    return Preintegration(delta_q=q, delta_p=p, delta_v=v, sum_dt=sdt), (dt, acc0, gyr0), starts


def preintegrate(imu: ImuBatch, t0, t1, ba, bg) -> Preintegration:
    """Quaternion + midpoint Δp/Δv preintegration over [t0, t1]; the first
    sample's dt is measured from t0."""
    return _midpoint_pass(imu, t0, ba, bg)[0]


class PreintegrationFull(NamedTuple):
    """Preintegration with 15-dim uncertainty (ref ``IntegrationBase``,
    utility.h:303-380).  Tangent-state order: [δp, δθ, δv, δba, δbg]."""

    delta_q: torch.Tensor     # [4]
    delta_p: torch.Tensor     # [3]
    delta_v: torch.Tensor     # [3]
    sum_dt: torch.Tensor      # []
    cov: torch.Tensor         # [15, 15] propagated noise covariance
    jac: torch.Tensor         # [15, 15] d(state)/d(state0); columns 9:15 are
    #                           the bias-correction Jacobians (∂Δ/∂ba, ∂Δ/∂bg)


def preintegrate_full(imu: ImuBatch, t0, t1, ba, bg, acc_n: float = 0.08,
                      gyr_n: float = 0.004, acc_w: float = 4e-5,
                      gyr_w: float = 2e-6) -> PreintegrationFull:
    """Midpoint preintegration with 15-dim covariance + bias Jacobians.

    The per-sample transition F and noise matrix V are the exact
    linearization of the midpoint step, by forward-mode autodiff of a
    tangent-space wrapper; each sample's measurement noise enters two
    consecutive steps (as step k's ``a1`` and step k+1's ``a0``), so the
    previous sample's noise is carried as 6 augmented dims and the
    correlation is exact.  Noise model: white measurement noise densities
    ``acc_n``/``gyr_n`` (discretized as σ²/dt) and bias random walks
    ``acc_w``/``gyr_w`` (σ²·dt)."""
    dev, dtype = imu.t.device, imu.acc.dtype
    m = imu.t.shape[0]
    # ---- phase 1: nominal trajectory; the state each sample starts from is
    # its linearization point ----
    pre, (dt, acc0s, gyr0s), starts = _midpoint_pass(imu, t0, ba, bg)
    qs, ps, vs = (torch.stack(x) for x in zip(*starts))

    # ---- phase 2: per-sample F/V by forward-mode autodiff, vmapped over
    # the samples ----
    def linearize(q0_, p0_, v0_, dt_i, a0, a1, g0, g1):
        q_new, p_new, v_new = _midpoint(q0_, p0_, v0_, ba, bg, a0, a1, g0, g1, dt_i)

        def perturbed(z):
            """z = [xi(15), n_prev(6): a0/g0 noise, n_new(6): a1/g1 noise]
            -> augmented output tangent [x'(15), n_new(6)]."""
            xi, np_, nn = z[:15], z[15:21], z[21:27]
            q_ = m3.quat_mul(q0_, m3.quat_exp(xi[3:6]))
            q2, p2, v2 = _midpoint(
                q_, p0_ + xi[:3], v0_ + xi[6:9], ba + xi[9:12], bg + xi[12:15],
                a0 + np_[0:3], a1 + nn[0:3], g0 + np_[3:6], g1 + nn[3:6], dt_i,
            )
            th = m3.quat_log(m3.quat_mul(m3.quat_conj(q_new), q2))
            return torch.cat([p2 - p_new, th, v2 - v_new, xi[9:12], xi[12:15], nn])

        # some torch builds carry the tangents of 0-dim intermediates in float64
        return jacfwd(perturbed)(torch.zeros(27, dtype=dtype, device=dev)).to(dtype)  # [21, 27]

    FV = vmap(linearize)(qs, ps, vs, dt, acc0s, imu.acc, gyr0s, imu.gyr)
    F_aug, V_aug = FV[:, :, :21], FV[:, :, 21:]              # [m,21,21], [m,21,6]
    dts = torch.clamp(dt, min=1e-4)
    qd = torch.cat([(acc_n ** 2 / dts)[:, None].expand(m, 3),
                    (gyr_n ** 2 / dts)[:, None].expand(m, 3)], 1)
    walk = torch.cat([torch.zeros((m, 9), dtype=dtype, device=dev),
                      (acc_w ** 2 * dts)[:, None].expand(m, 3),
                      (gyr_w ** 2 * dts)[:, None].expand(m, 3),
                      torch.zeros((m, 6), dtype=dtype, device=dev)], 1)
    vqv = (V_aug * qd[:, None, :]) @ V_aug.transpose(1, 2)
    walk = torch.diag_embed(walk)

    # ---- phase 3: the 21x21 covariance / 15x15 Jacobian recurrence ----
    cov = torch.zeros((21, 21), dtype=dtype, device=dev)
    jac = torch.eye(15, dtype=dtype, device=dev)
    for k in range(m):
        Fk, valid = F_aug[k], imu.mask[k]
        cov = torch.where(valid, Fk @ cov @ Fk.T + vqv[k] + walk[k], cov)
        jac = torch.where(valid, Fk[:15, :15] @ jac, jac)
    return PreintegrationFull(*pre, cov=cov[:15, :15], jac=jac)


def bias_corrected_delta(pre: PreintegrationFull, dba, dbg):
    """First-order bias correction of the preintegrated deltas by the bias
    Jacobians (the reference's ``IntegrationBase::evaluate`` blocks):
    (delta_q, delta_p, delta_v) for the biases moved by ``dba``, ``dbg``."""
    dp = pre.delta_p + pre.jac[0:3, 9:12] @ dba + pre.jac[0:3, 12:15] @ dbg
    dv = pre.delta_v + pre.jac[6:9, 9:12] @ dba + pre.jac[6:9, 12:15] @ dbg
    dth = pre.jac[3:6, 12:15] @ dbg
    dq = m3.quat_normalize(m3.quat_mul(pre.delta_q, m3.quat_exp(dth)))
    return dq, dp, dv


def gravity_init(preint: Preintegration, q_w_curr, t_ij, dt, gravity: float = 9.81):
    """First-frame gravity direction by min-norm least squares around the
    prior (0, 0, g), renormalized; returns (g, q_body2world)."""
    dtype, dev = t_ij.dtype, t_ij.device
    R = m3.quat_to_mat(q_w_curr)
    z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    A_p = torch.cat([0.5 * dt * dt * R, -dt * R, z3], 1)
    A_v = torch.cat([dt * R, -R, R], 1)
    A = torch.cat([A_p, A_v], 0)
    rhs = torch.cat([preint.delta_p - t_ij, preint.delta_v])
    g_w = m3.const((0.0, 0.0, gravity), dtype, dev)
    x0 = torch.cat([g_w, torch.zeros(6, dtype=dtype, device=dev)])
    r0 = rhs - A @ x0
    sol = torch.linalg.solve_ex(A @ A.T + 1e-6 * torch.eye(6, dtype=dtype, device=dev), r0)[0]
    x = x0 + A.T @ sol
    g = x[:3]
    g = gravity * g / torch.clamp(m3.norm(g), min=1e-6)
    axis = m3.cross(g, g_w)
    axis_n = m3.norm(axis)
    angle = torch.atan2(axis_n, torch.dot(g, g_w))
    axis = torch.where(axis_n < 1e-8, m3.const((1.0, 0.0, 0.0), dtype, dev),
                       axis / torch.clamp(axis_n, min=1e-8))
    return g, m3.quat_normalize(m3.quat_from_axis_angle(axis, angle))
