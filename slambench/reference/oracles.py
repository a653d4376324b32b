"""Frozen copies of the numpy oracles the reference is built from: the
ground fit (scanRegistration.cpp:307-431) and the two-pose scan-to-map solve
(RGC_mapping.cpp:1076-1354 with Ceres' trust-region LM), each a sequential
transliteration of the C++ source written apart from the program.

Copied from the port's ``utils/parity.py`` so that the benchmark's yardstick
cannot change with the program.  One change: ``reference_ground_fit`` takes
a ``prec`` (``slambench.reference.precision``) whose ``operand`` rounds the
inputs of its matrix products, so the same code runs as the float64
reference, as a float32 witness and as the TF32 control.  The mapping
functions here are the slow originals that ``stages.py``'s vectorized solve
is held to (``slambench/tests/test_slambench_stages.py``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .precision import FLOAT64, Precision


def reference_ground_fit(
    xyz: np.ndarray,            # [N, 3] flat ring-major organized cloud
    rng: np.ndarray,            # [N] per-point range
    ring_sizes: Sequence[int],  # per-ring point counts (rings contiguous)
    expected_ranges: Sequence[float],   # Ground_scan_range per ring
    ground_scan_rings: int = 7,         # groundScanInd
    range_gate: float = 0.8,
    lidar_height: float = 0.56,         # laderH
    ground_z_max: float = 0.3,
    prec: Precision = FLOAT64,
) -> Dict[str, np.ndarray]:
    """Exact sequential ground marking + weighted PCA + robustified distance.

    Quirks kept: the neighbor flood window is n ∈ [-5, 5) around each seed
    with the *seed's* ring gate; each passing neighbor is PUSHED again for
    every seed that floods it (duplicates weight the moments and the distance
    pass); flood indices run over the flat array and can cross ring
    boundaries; the planarity check (λ1 > 6 λ0) only prints — it does not
    gate the published plane; and ``i / (groundScanInd-1)`` is C++ INTEGER
    division (both ints), so the ring gate and weight are step functions
    (0.8/1.5 for rings 0..gsi-2, 1.6/0.5 for ring gsi-1), not linear ramps.
    """
    dtype = prec.np_dtype
    xyz = np.asarray(xyz, dtype)
    rng = np.asarray(rng, dtype)
    op = prec.operand
    n = len(xyz)
    gsi = ground_scan_rings
    marked = np.zeros(n, bool)
    pushes: List[Tuple[int, float]] = []   # (flat index, groundweight)

    start = 0
    for i, size in enumerate(ring_sizes):
        if i >= gsi:
            break
        th = range_gate * (1.0 + i // (gsi - 1))   # C++ int division
        gw = 1.5 - i // (gsi - 1)
        for col in range(5, int(size) - 5):
            ci = start + col
            if abs(rng[ci] - expected_ranges[i]) < th and xyz[ci, 2] < ground_z_max:
                marked[ci] = True
                for off in range(-5, 5):
                    j = ci + off
                    if 0 <= j < n and abs(rng[j] - rng[ci]) < th / 2:
                        marked[j] = True
                        pushes.append((j, gw))
        start += int(size)

    out: Dict[str, np.ndarray] = {
        "marked": marked,
        "groundsize": np.asarray(len(pushes)),
    }
    if not pushes:
        return out

    idx = np.array([p[0] for p in pushes])
    w = np.array([p[1] for p in pushes], dtype)
    pts = xyz[idx]
    wsum = w.sum()
    center = op(w) @ op(pts) / wsum
    d = pts - center
    cov = op(w[:, None] * d).T @ op(d) / wsum
    evals, evecs = np.linalg.eigh(cov)          # ascending like SelfAdjoint
    normal = evecs[:, 0] / np.linalg.norm(evecs[:, 0])
    if center @ normal < 0:
        normal = -normal
    planarity_ok = evals[1] > 6.0 * evals[0]

    d_unit = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), np.finfo(dtype).tiny)
    dw = 1.0 - 100.0 * np.abs(op(d_unit) @ op(normal))
    dw = np.where(dw < 0, 0.1, dw)
    gs1 = dw.sum()
    distance = op(dw) @ op(op(pts) @ op(normal)) / gs1
    gs1 = gs1 / len(pushes)
    if distance / lidar_height > 1.1 or distance / lidar_height < 0.9:
        distance = lidar_height
    if gs1 < 0.9:
        distance = 0.9 * lidar_height + 0.1 * distance

    out.update(
        center=center, normal=normal, v1=evecs[:, 1], v2=evecs[:, 2],
        distance=np.asarray(distance), source=np.asarray(1.0 - gs1),
        planarity_ok=np.asarray(planarity_ok), evals=evals,
        weight_of=_scatter_weights(n, idx, w),
    )
    return out


def _scatter_weights(n: int, idx: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Total push weight per flat point index (engine-side comparison aid)."""
    out = np.zeros(n)
    np.add.at(out, idx, w)
    return out


# ---------------------------------------------------------------------------
# (b) complementary attitude filter (RGC_odometer.cpp:545-625)
# ---------------------------------------------------------------------------



def _quat_rotate_xyzw(q, v):
    """Eigen quaternion rotation, q stored (x, y, z, w)."""
    x, y, z, w = q
    uv = 2.0 * np.cross(q[:3], v)
    return v + w * uv + np.cross(q[:3], uv)


def _quat_mul_xyzw(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _quat_conj_xyzw(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def _eigen_quat_plus(q, delta):
    """ceres::EigenQuaternionParameterization::Plus — half-angle delta."""
    nd = np.linalg.norm(delta)
    if nd > 0.0:
        sin_by = np.sin(nd) / nd
        dq = np.array([sin_by * delta[0], sin_by * delta[1],
                       sin_by * delta[2], np.cos(nd)])
        out = _quat_mul_xyzw(dq, q)
    else:
        out = q.copy()
    return out


def _quat2euler_lidarfactor(q_xyzw):
    """Quaternion2EulerAngle (lidarFactor.hpp:405-432) -> [yaw, pitch, roll]."""
    x, y, z, w = q_xyzw
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    roll = np.arctan2(sinr_cosp, cosr_cosp)
    sinp = 2.0 * (w * y - x * z)
    pitch = np.pi / 2 if sinp >= 1 else (-np.pi / 2 if sinp <= -1 else np.arcsin(sinp))
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    yaw = np.arctan2(siny_cosp, cosy_cosp)
    return np.array([yaw, pitch, roll])


def reference_mapping_associate(
    pts_sensor: np.ndarray,     # [N, 3] downsampled feature cloud
    conf: np.ndarray,           # [N] normal_x confidence
    q: np.ndarray, t: np.ndarray,   # pose used by pointAssociateToMap
    map_pts: np.ndarray,        # [M, 3] world-frame DS map
    kind: str,                  # "corner" | "surf"
) -> List[dict]:
    """One association pass: exact 5-NN + line/plane fit + gates.

    Corner (RGC_mapping.cpp:1093-1141): 5-NN, sqDis[4] < 1.0, raw-sum
    covariance of the 5 neighbors, accept if λ2 > 3 λ1, line endpoints
    center ± 0.1 · dominant eigenvector.
    Surf (RGC_mapping.cpp:1191-1238): 5-NN, sqDis[4] < 2.0, QR solve of
    A n = -1, d = 1/|n|, accept if all five |n·p + d| <= 0.2.
    Returns one dict per point: {accept, and the factor params if accepted}.
    """
    out = []
    for i in range(len(pts_sensor)):
        p_sel = _quat_rotate_xyzw(q, pts_sensor[i]) + t
        d2 = np.sum((map_pts - p_sel) ** 2, axis=1)
        nn = np.argsort(d2, kind="stable")[:5]
        rec = {"accept": False}
        if kind == "corner":
            if d2[nn[4]] < 1.0:
                near = map_pts[nn]
                center = near.mean(axis=0)
                dd = near - center
                cov = dd.T @ dd
                evals, evecs = np.linalg.eigh(cov)
                if evals[2] > 3.0 * evals[1]:
                    unit = evecs[:, 2]
                    rec = {
                        "accept": True,
                        "pa": center + 0.1 * unit,
                        "pb": center - 0.1 * unit,
                        "var": float(conf[i]),
                        "point": pts_sensor[i],
                    }
        else:
            if d2[nn[4]] < 2.0:
                A = map_pts[nn]
                norm, *_ = np.linalg.lstsq(A, -np.ones(5), rcond=None)
                neg_oa = 1.0 / np.linalg.norm(norm)
                norm = norm / np.linalg.norm(norm)
                if np.all(np.abs(A @ norm + neg_oa) <= 0.2):
                    rec = {
                        "accept": True,
                        "n": norm,
                        "neg_oa": float(neg_oa),
                        "var": float(conf[i]),
                        "point": pts_sensor[i],
                    }
        out.append(rec)
    return out


def _mapping_factor_blocks(
    assoc_c, assoc_cl, assoc_s, assoc_sl,
    delta_q_imu, imu_cov, imu_pr, imu_pr_last,
    grounds,
):
    """Residual blocks as (fn(x) -> r, loss) with x = (q, t, ql, tl).

    Block order mirrors the reference's AddResidualBlock order; order does
    not affect the normal equations, only the bookkeeping."""
    blocks = []

    def edge_block(rec, which):
        def fn(x):
            qq, tt = (x[0], x[1]) if which == "cur" else (x[2], x[3])
            lp = _quat_rotate_xyzw(qq, rec["point"]) + tt
            nu = np.cross(lp - rec["pa"], lp - rec["pb"])
            de = np.linalg.norm(rec["pa"] - rec["pb"])
            return nu / de * rec["var"]
        return fn

    def plane_block(rec, which):
        def fn(x):
            qq, tt = (x[0], x[1]) if which == "cur" else (x[2], x[3])
            pw = _quat_rotate_xyzw(qq, rec["point"]) + tt
            return np.array([(rec["n"] @ pw + rec["neg_oa"]) * rec["var"]])
        return fn

    for rec in assoc_c:
        if rec["accept"]:
            blocks.append((edge_block(rec, "cur"), "huber"))
    for rec in assoc_cl:
        if rec["accept"]:
            blocks.append((edge_block(rec, "last"), "huber"))
    for rec in assoc_s:
        if rec["accept"]:
            blocks.append((plane_block(rec, "cur"), "huber"))
    for rec in assoc_sl:
        if rec["accept"]:
            blocks.append((plane_block(rec, "last"), "huber"))

    if delta_q_imu is not None:
        dq = np.asarray(delta_q_imu, float)    # xyzw

        def rel_r(x):
            qij = _quat_mul_xyzw(_quat_conj_xyzw(x[2]), x[0])
            err = _quat_mul_xyzw(_quat_conj_xyzw(dq), qij)
            return 2.0 * err[:3] / imu_cov
        blocks.append((rel_r, None))

        p_m, r_m = imu_pr

        def pr_cur(x):
            ypr = _quat2euler_lidarfactor(x[0])
            return 2.0 * np.array([ypr[1] - p_m, ypr[2] - r_m]) / 0.02
        blocks.append((pr_cur, None))

        p_l, r_l = imu_pr_last

        def pr_last(x):
            ypr = _quat2euler_lidarfactor(x[2])
            return 2.0 * np.array([ypr[1] - p_l, ypr[2] - r_l]) / 0.02
        blocks.append((pr_last, None))

    if grounds is not None:
        (g_last, g_cur, q_hist, g_last2, q_hist2, q_w_last2, t_w_last2) = grounds

        def ground_fn(g_l, g_c, q_h, get_cur, get_last, var=0.2):
            # Ground_DeltaFactor_goable (lidarFactor.hpp:352-403): last pose
            # is a constant SNAPSHOT (last_q_q/last_t_t); for the current-
            # pose factor that snapshot is the (aliased) para_q_last value at
            # problem creation, handled by the caller passing a closure.
            def fn(x):
                qq, tt = get_cur(x)
                q_l, t_l = get_last(x)
                q_lc = _quat_mul_xyzw(_quat_conj_xyzw(q_l), qq)
                t_lc = _quat_rotate_xyzw(_quat_conj_xyzw(q_l), tt - t_l)
                norm_cur = _quat_rotate_xyzw(q_lc, g_c["normal"])
                delta_t = _quat_rotate_xyzw(q_h, t_lc)
                dist_cur = g_c["distance"] + delta_t[2]
                return np.array([
                    (g_l["distance"] - dist_cur) / (var / 1000.0),
                    abs(g_l["v1"] @ norm_cur) / (var * 10.0),
                    abs(g_l["v2"] @ norm_cur) / (var * 10.0),
                ])
            return fn
        return blocks, ground_fn, (g_last, g_cur, q_hist, g_last2, q_hist2,
                                   q_w_last2, t_w_last2)
    return blocks, None, None


def _ceres_lm_solve(blocks, x0, max_iterations=6, huber_delta=0.1,
                    kinds=("quat", "vec3", "quat", "vec3")):
    """ceres::Solve with TrustRegionMinimizer + LM strategy defaults.

    ``kinds`` names each parameter block of x ("quat" = Eigen quaternion
    parameterization, xyzw storage, 3-dim local tangent; "vec3" = plain);
    local dim = 3·len(kinds).  Jacobians by central finite differences in
    the local parametrization (stands in for autodiff; ~1e-10 accurate).
    """
    radius = 1e4
    decrease_factor = 2.0
    x = [np.asarray(v, float).copy() for v in x0]
    dim = 3 * len(kinds)

    def plus(x, step):
        out = []
        for i, kind in enumerate(kinds):
            d = step[3 * i: 3 * i + 3]
            out.append(_eigen_quat_plus(x[i], d) if kind == "quat"
                       else x[i] + d)
        return out

    def corrected(x):
        """Residual vector + jacobian with the Huber corrector applied."""
        rows, jrows = [], []
        eps = 1e-7
        for fn, loss in blocks:
            r = np.atleast_1d(fn(x))
            J = np.zeros((len(r), dim))
            for c in range(dim):
                dp = np.zeros(dim)
                dp[c] = eps
                rp = np.atleast_1d(fn(plus(x, dp)))
                rm = np.atleast_1d(fn(plus(x, -dp)))
                J[:, c] = (rp - rm) / (2 * eps)
            if loss == "huber":
                s = float(r @ r)
                if s > huber_delta ** 2:
                    w = np.sqrt(huber_delta / np.sqrt(s))
                    r = r * w
                    J = J * w
            rows.append(r)
            jrows.append(J)
        return np.concatenate(rows), np.concatenate(jrows, axis=0)

    def total_cost(x):
        c = 0.0
        for fn, loss in blocks:
            r = np.atleast_1d(fn(x))
            s = float(r @ r)
            if loss == "huber" and s > huber_delta ** 2:
                c += 2 * huber_delta * np.sqrt(s) - huber_delta ** 2
            else:
                c += s
        return 0.5 * c

    cost = total_cost(x)
    for _ in range(max_iterations):
        r, J = corrected(x)
        g = J.T @ r
        if np.abs(g).max() <= 1e-10:
            break
        JtJ_diag = np.sum(J * J, axis=0)
        D = np.sqrt(np.clip(JtJ_diag, 1e-6, 1e32) / radius)
        # DENSE_QR on the augmented system [J; diag(D)] step = [-r; 0]
        A = np.concatenate([J, np.diag(D)], axis=0)
        rhs = np.concatenate([-r, np.zeros(dim)])
        step, *_ = np.linalg.lstsq(A, rhs, rcond=None)
        model_res = J @ step
        model_cost_change = -model_res @ (r + model_res / 2.0)
        accepted = False
        if model_cost_change > 0:
            x_new = plus(x, step)
            new_cost = total_cost(x_new)
            relative_decrease = (cost - new_cost) / model_cost_change
            if relative_decrease > 1e-3:
                accepted = True
                radius = radius / max(1.0 / 3.0,
                                      1.0 - (2.0 * relative_decrease - 1.0) ** 3)
                radius = min(radius, 1e16)
                decrease_factor = 2.0
                cost_change = cost - new_cost
                x = x_new
                for i, kind in enumerate(kinds):
                    if kind == "quat":
                        x[i] = x[i] / np.linalg.norm(x[i])
                converged = (
                    abs(cost_change) <= 1e-6 * cost
                    or np.linalg.norm(step)
                    <= 1e-8 * (np.linalg.norm(np.concatenate(x)) + 1e-8)
                )
                cost = new_cost
                if converged:
                    break
        if not accepted:
            radius = radius / decrease_factor
            decrease_factor *= 2.0
            if radius < 1e-32:
                break
    return x


def reference_mapping_solve(
    corner_cur, corner_cur_conf,
    surf_cur, surf_cur_conf,
    corner_last, corner_last_conf,
    surf_last, surf_last_conf,
    corner_map, surf_map,
    q0, t0, ql0, tl0,           # xyzw quats + translations
    delta_q_imu=None, imu_cov=None, imu_pr=None, imu_pr_last=None,
    grounds=None,               # (g_last, g_cur, q_hist, g_last2, q_hist2,
                                #  q_w_last2, t_w_last2); g_* are dicts with
                                #  normal/v1/v2/distance
    outer_iters=2,
    max_inner_iters=6,
):
    """Full two-pose scan-to-map replay (RGC_mapping.cpp:1076-1354).

    Returns {"q", "t", "ql", "tl", "assoc": per-outer dict of accept masks
    and factor params, "r0": residual blocks at each outer's start}."""
    x = [np.asarray(q0, float).copy(), np.asarray(t0, float).copy(),
         np.asarray(ql0, float).copy(), np.asarray(tl0, float).copy()]
    assoc_log = []
    for _outer in range(outer_iters):
        assoc_c = reference_mapping_associate(
            corner_cur, corner_cur_conf, x[0], x[1], corner_map, "corner")
        assoc_cl = reference_mapping_associate(
            corner_last, corner_last_conf, x[2], x[3], corner_map, "corner")
        assoc_s = reference_mapping_associate(
            surf_cur, surf_cur_conf, x[0], x[1], surf_map, "surf")
        assoc_sl = reference_mapping_associate(
            surf_last, surf_last_conf, x[2], x[3], surf_map, "surf")
        blocks, ground_fn, gparams = _mapping_factor_blocks(
            assoc_c, assoc_cl, assoc_s, assoc_sl,
            delta_q_imu, imu_cov, imu_pr, imu_pr_last, grounds,
        )
        if ground_fn is not None:
            (g_last, g_cur, q_hist, g_last2, q_hist2,
             q_w_last2, t_w_last2) = gparams
            # current-pose ground factor: last pose is snapshotted at problem
            # creation from the ALIASED para_q_last (RGC_mapping.cpp:1322-26)
            ql_snap, tl_snap = x[2].copy(), x[3].copy()
            blocks.append((ground_fn(
                g_last, g_cur, q_hist,
                get_cur=lambda x: (x[0], x[1]),
                get_last=lambda x, q=ql_snap, t=tl_snap: (q, t),
            ), None))
            blocks.append((ground_fn(
                g_last2, g_last, q_hist2,
                get_cur=lambda x: (x[2], x[3]),
                get_last=lambda x: (np.asarray(q_w_last2, float),
                                    np.asarray(t_w_last2, float)),
            ), None))
        assoc_log.append({
            "corner_mask": np.array([a["accept"] for a in assoc_c]),
            "corner_last_mask": np.array([a["accept"] for a in assoc_cl]),
            "surf_mask": np.array([a["accept"] for a in assoc_s]),
            "surf_last_mask": np.array([a["accept"] for a in assoc_sl]),
            "assoc": (assoc_c, assoc_cl, assoc_s, assoc_sl),
            "r0": [np.atleast_1d(fn(x)) for fn, _ in blocks],
            "x0": [v.copy() for v in x],
        })
        x = _ceres_lm_solve(blocks, x, max_iterations=max_inner_iters)
    return {"q": x[0], "t": x[1], "ql": x[2], "tl": x[3], "outer": assoc_log}


# ---------------------------------------------------------------------------
# (i) odometry factor fusion (RGC_odometer.cpp:1024-1213)
# ---------------------------------------------------------------------------


