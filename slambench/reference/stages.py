"""The reference's stages, each worked out from the inputs the benchmark
handed the program and from the program's own state around one call.

The program (features -> odometry -> mapping, float32) is chaotic: a 1e-7
change to an input moves a trajectory by centimetres, so two honest runs of
many scans part ways.  The reference therefore does not run the program's
whole step; it takes each stage's inputs from the program's state before
and after the call and works the stage out again from the C++ semantics
(``oracles.py``), independently of the program's code:

* ``ground``: the sweep's ground plane (scanRegistration.cpp's ground
  marking and weighted PCA), from the sweep alone;
* ``mapping``: the local map assembled from the keyframe store the program
  held before the call, the five-nearest-neighbour line and plane
  associations, and the two-pose 12-dim Levenberg-Marquardt solve with its
  IMU and ground factors, started from the program's odometry pose and fed
  the program's current-frame features;
* ``keyframe``: the keyframe decision on the program's map pose, and the
  store's new row against it.

Everything runs in a ``Precision``: float64 (the reference), float32 (a
witness) or TF32 (the control).  Quaternions are (x, y, z, w), as the
oracles keep them; the program's (w, x, y, z) are turned on the way in.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from . import oracles
from .precision import Precision

HUBER = 0.1
MAP_KNN = 5
KNN_CHUNK = 256


# ---------------------------------------------------------------------------
# quaternions, (x, y, z, w)
# ---------------------------------------------------------------------------


def xyzw(q_wxyz: torch.Tensor) -> torch.Tensor:
    return torch.cat([q_wxyz[..., 1:], q_wxyz[..., :1]], -1)


def wxyz(q_xyzw: torch.Tensor) -> torch.Tensor:
    return torch.cat([q_xyzw[..., 3:], q_xyzw[..., :3]], -1)


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Eigen's rotation of ``v`` by ``q`` (broadcast over leading dims)."""
    u, w = q[..., :3], q[..., 3:]
    uv = 2.0 * torch.cross(u.expand_as(v), v, dim=-1)
    return v + w * uv + torch.cross(u.expand_as(uv), uv, dim=-1)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_plus(q: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """ceres::EigenQuaternionParameterization::Plus (half-angle delta)."""
    nd = torch.linalg.vector_norm(delta)
    if float(nd) == 0.0:
        return q.clone()
    dq = torch.cat([torch.sin(nd) / nd * delta, torch.cos(nd).reshape(1)])
    return qmul(dq, q)


def quat_plus_linear(q: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The same map to first order at ``delta = 0``, smooth there: what the
    Jacobians are taken of."""
    return qmul(torch.cat([delta, torch.ones_like(delta[:1])]), q)


def ypr_of(q: torch.Tensor) -> torch.Tensor:
    """(yaw, pitch, roll) of a rotation matrix (Eigen's eulerAngles(2,1,0)
    convention as the mapping node's keyframe test reads it)."""
    x, y, z, w = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r10 = 2 * (x * y + z * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack([torch.atan2(r10, r00),
                        torch.atan2(-r20, torch.sqrt(r21 ** 2 + r22 ** 2)),
                        torch.atan2(r21, r22)], -1)


def euler_lidarfactor(q: torch.Tensor) -> torch.Tensor:
    """Quaternion2EulerAngle (lidarFactor.hpp:405-432) -> [yaw, pitch, roll]."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - x * z), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([yaw, pitch, roll], -1)


def angle_between(qa: torch.Tensor, qb: torch.Tensor) -> float:
    """The rotation angle between two unit quaternions (q and -q alike), as
    2 atan2(|a - b|, |a + b|), which keeps its digits near 0."""
    qa, qb = qnormalize(qa.double()), qnormalize(qb.double())
    if float((qa * qb).sum()) < 0:
        qb = -qb
    return float(2.0 * torch.atan2(torch.linalg.vector_norm(qa - qb),
                                   torch.linalg.vector_norm(qa + qb)))


def wrap(a: torch.Tensor) -> torch.Tensor:
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


# ---------------------------------------------------------------------------
# features: the ground plane of one sweep
# ---------------------------------------------------------------------------


def expected_ground_ranges(cfg: dict) -> Tuple[float, ...]:
    """Ground_scan_range for the configured sensor height: h / sin|elev| of
    ring i, elev = -15 + 2 i degrees on a VLP-16 (ring 0 the lowest)."""
    if cfg["n_scans"] != 16:
        raise ValueError("the reference's ground table is the VLP-16's")
    return tuple(cfg["lidar_height"] / max(math.sin(abs(-15.0 + 2.0 * i) * math.pi / 180.0),
                                           1e-3)
                 for i in range(cfg["ground_scan_rings"] + 1))


def organize(scan: Dict[str, np.ndarray], cfg: dict):
    """The sweep's points as the front end orders them: in the cloud's
    capacity (valid points first when the sweep holds more), range-gated
    with the rear cone behind the robot cut, ring-major and in time order
    within a ring.  Returns (xyz [N, 3] float64, points a ring)."""
    mask = np.asarray(scan["mask"], bool)
    n = mask.shape[0]
    keep_idx = np.argsort(~mask, kind="stable")[:cfg["max_points"]] if n > cfg["max_points"] \
        else np.arange(n)
    xyz = np.asarray(scan["xyz"], np.float32)[keep_idx].astype(np.float64)
    ring = np.asarray(scan["ring"])[keep_idx].astype(np.int64)
    rel = np.asarray(scan["rel_time"], np.float32)[keep_idx].astype(np.float64)
    m = mask[keep_idx]
    d2 = (xyz * xyz).sum(-1)
    m = m & (d2 > cfg["minimum_range"] ** 2) & (d2 < cfg["maximum_range"] ** 2)
    m = m & ~((xyz[:, 0] < 0) & (np.abs(xyz[:, 1]) < 0.5))
    order = np.lexsort((rel, ring))
    order = order[m[order]]
    sizes = np.bincount(ring[order], minlength=cfg["n_scans"])[:cfg["n_scans"]]
    if sizes.max(initial=0) > cfg["max_points_per_ring"]:
        raise ValueError(f"a ring of {sizes.max()} points exceeds max_points_per_ring")
    return xyz[order], sizes


def ground(scan: Dict[str, np.ndarray], cfg: dict, prec: Precision) -> Dict[str, object]:
    """The sweep's ground plane: {valid, normal [3], distance}."""
    xyz, sizes = organize(scan, cfg)
    o = oracles.reference_ground_fit(
        xyz, np.linalg.norm(xyz, axis=-1), sizes, expected_ground_ranges(cfg),
        ground_scan_rings=cfg["ground_scan_rings"], range_gate=cfg["ground_range_gate"],
        lidar_height=cfg["lidar_height"], ground_z_max=cfg["ground_z_max"], prec=prec)
    if int(o["groundsize"]) == 0:
        return {"valid": False, "normal": None, "distance": None}
    return {"valid": bool(o["planarity_ok"]), "normal": np.asarray(o["normal"], np.float64),
            "distance": float(o["distance"])}


# ---------------------------------------------------------------------------
# mapping: local map, IMU rotation, associations, the 12-dim solve
# ---------------------------------------------------------------------------


def local_map(kf_q, kf_t, kf_pts, kf_mask, kf_count: int, t0, cfg: dict, voxel: float,
              prec: Precision) -> torch.Tensor:
    """The nearest ``surrounding_keyframes`` keyframes within
    ``surrounding_radius`` of ``t0``, in the map frame, as the centroids of
    a ``voxel`` grid anchored at floor(t0).  Returns [V, 3]."""
    dt = prec.dtype
    K = kf_t.shape[0]
    d = torch.linalg.vector_norm(kf_t.to(dt) - t0[None, :], dim=-1)
    d = torch.where(torch.arange(K, device=d.device) < kf_count, d, torch.full_like(d, math.inf))
    d_sorted, sel = torch.sort(d, stable=True)
    k_near = min(cfg["surrounding_keyframes"], K)
    sel = sel[:k_near][d_sorted[:k_near] < cfg["surrounding_radius"]]
    pts = qrot(xyzw(kf_q[sel].to(dt))[:, None, :], kf_pts[sel].to(dt)) + kf_t[sel].to(dt)[:, None]
    pts = pts[kf_mask[sel]]
    origin = torch.floor(t0)
    rel = pts - origin
    keys, inverse = torch.unique(torch.floor(rel / voxel).to(torch.int64), dim=0,
                                 return_inverse=True)
    sums = torch.zeros((keys.shape[0], 3), dtype=dt, device=rel.device).index_add_(0, inverse, rel)
    counts = torch.bincount(inverse, minlength=keys.shape[0]).to(dt)
    return sums / counts[:, None] + origin


def imu_rotation(t: np.ndarray, gyr: np.ndarray, t0: float, bg: np.ndarray) -> torch.Tensor:
    """The gyro's midpoint rotation over the scan's IMU window (VINS'
    IntegrationBase, utility.h:303-380), the first sample's interval taken
    from the previous scan's stamp, bias removed.  (x, y, z, w)."""
    t = np.asarray(t, np.float32).astype(np.float64)
    g = np.asarray(gyr, np.float32).astype(np.float64)
    q = np.array([0.0, 0.0, 0.0, 1.0])
    for k in range(len(t)):
        dt = max(t[k] - (t0 if k == 0 else t[k - 1]), 0.0)
        un = 0.5 * ((g[k - 1] if k else g[k]) + g[k]) - bg
        dq = np.concatenate([un * dt / 2.0, [1.0]])
        dq = dq / np.linalg.norm(dq)
        q = oracles._quat_mul_xyzw(q, dq)
        q = q / np.linalg.norm(q)
    return torch.tensor(q, dtype=torch.float64)


def _knn5(pw: torch.Tensor, map_pts: torch.Tensor):
    """Exact 5 nearest map points of each query (ties to the lower index):
    (squared distances [N, 5], indices [N, 5])."""
    d2s, idxs = [], []
    for s in range(0, pw.shape[0], KNN_CHUNK):
        d2 = ((pw[s:s + KNN_CHUNK, None, :] - map_pts[None, :, :]) ** 2).sum(-1)
        d2_sorted, idx = torch.sort(d2, dim=1, stable=True)
        d2s.append(d2_sorted[:, :MAP_KNN])
        idxs.append(idx[:, :MAP_KNN])
    return torch.cat(d2s), torch.cat(idxs)


def associate(pts, conf, mask, q, t, map_pts, kind: str, prec: Precision) -> Dict[str, torch.Tensor]:
    """One association pass (RGC_mapping.cpp:1093-1141 corner, 1191-1238
    surf): the five nearest map points of each feature point put in the map
    by (q, t), a line (corner) or plane (surf) fitted to them, gated."""
    n = pts.shape[0]
    if n == 0 or map_pts.shape[0] < MAP_KNN:
        return {"ok": torch.zeros(n, dtype=torch.bool, device=pts.device)}
    pw = qrot(q, pts) + t
    d2, nn = _knn5(pw, map_pts)
    near = map_pts[nn]                                          # [N, 5, 3]
    if kind == "corner":
        center = near.mean(1)
        dd = near - center[:, None, :]
        cov = prec.mm(dd.transpose(1, 2), dd)
        evals, evecs = torch.linalg.eigh(cov)
        unit = evecs[..., 2]
        ok = mask & (d2[:, 4] < 1.0) & (evals[:, 2] > 3.0 * evals[:, 1])
        return {"ok": ok, "pa": center + 0.1 * unit, "pb": center - 0.1 * unit}
    A = prec.operand(near)
    Q, R = torch.linalg.qr(A)
    rhs = -prec.operand(Q).transpose(1, 2).sum(-1, keepdim=True)
    sol = torch.linalg.solve_triangular(prec.operand(R), rhs, upper=True)[..., 0]
    norm = torch.linalg.vector_norm(sol, dim=-1)
    neg_oa = 1.0 / norm
    nrm = sol / norm[:, None]
    fit = prec.mm(near, nrm[:, :, None])[..., 0] + neg_oa[:, None]
    ok = mask & (d2[:, 4] < 2.0) & torch.isfinite(fit).all(1) & (fit.abs() <= 0.2).all(1)
    return {"ok": ok, "n": nrm, "neg_oa": neg_oa}


class _Problem:
    """The solve's residual blocks at one outer iteration, vectorized (the
    blocks of ``oracles._mapping_factor_blocks``)."""

    def __init__(self, feats, assoc, imu, grounds, x_outer, prec: Precision):
        self.prec = prec
        self.lidar = []
        for name, which in (("corner", 0), ("corner_last", 2), ("surf", 0), ("surf_last", 2)):
            pts, conf = feats[name]
            a = assoc[name]
            ok = a["ok"]
            if not bool(ok.any()):
                continue
            blk = {"which": which, "point": pts[ok], "var": conf[ok]}
            if "pa" in a:
                blk.update(pa=a["pa"][ok], pb=a["pb"][ok])
            else:
                blk.update(n=a["n"][ok], neg_oa=a["neg_oa"][ok])
            self.lidar.append(blk)
        self.imu = imu
        self.grounds = grounds
        self.snap = (x_outer[2].clone(), x_outer[3].clone())

    def _lidar_r(self, x):
        out = []
        for b in self.lidar:
            q, t = x[b["which"]], x[b["which"] + 1]
            p = qrot(q, b["point"]) + t
            if "pa" in b:
                nu = torch.cross(p - b["pa"], p - b["pb"], dim=-1)
                de = torch.linalg.vector_norm(b["pa"] - b["pb"], dim=-1, keepdim=True)
                out.append(nu / de * b["var"][:, None])
            else:
                out.append((((b["n"] * p).sum(-1) + b["neg_oa"]) * b["var"])[:, None])
        return out

    def _ground_r(self, g_l, g_c, q_h, cur, last, var=0.2):
        qq, tt = cur
        q_l, t_l = last
        q_lc = qmul(qconj(q_l), qq)
        t_lc = qrot(qconj(q_l), tt - t_l)
        norm_cur = qrot(q_lc, g_c["normal"])
        dist_cur = g_c["distance"] + qrot(q_h, t_lc)[2]
        return torch.stack([(g_l["distance"] - dist_cur) / (var / 1000.0),
                            torch.abs((g_l["v1"] * norm_cur).sum()) / (var * 10.0),
                            torch.abs((g_l["v2"] * norm_cur).sum()) / (var * 10.0)])

    def _other_r(self, x):
        out = []
        if self.imu is not None:
            dq, imu_cov, (p_m, r_m), (p_l, r_l) = self.imu
            err = qmul(qconj(dq), qmul(qconj(x[2]), x[0]))
            out.append(2.0 * err[:3] / imu_cov)
            ypr = euler_lidarfactor(x[0])
            out.append(2.0 * torch.stack([ypr[1] - p_m, ypr[2] - r_m]) / 0.02)
            ypr_l = euler_lidarfactor(x[2])
            out.append(2.0 * torch.stack([ypr_l[1] - p_l, ypr_l[2] - r_l]) / 0.02)
        if self.grounds is not None:
            g_last, g_cur, q_hist, g_last2, q_hist2, q_w_last2, t_w_last2 = self.grounds
            out.append(self._ground_r(g_last, g_cur, q_hist, (x[0], x[1]), self.snap))
            out.append(self._ground_r(g_last2, g_last, q_hist2, (x[2], x[3]),
                                      (q_w_last2, t_w_last2)))
        return out

    def residuals(self, x):
        """(lidar blocks [B, rows] list, the NULL-loss residuals [R])."""
        other = self._other_r(x)
        dt = x[1].dtype
        return self._lidar_r(x), (torch.cat(other) if other else x[1].new_zeros(0, dtype=dt))

    def total_cost(self, x) -> torch.Tensor:
        lidar, other = self.residuals(x)
        c = other.square().sum()
        for r in lidar:
            s = r.square().sum(-1)
            c = c + torch.where(s > HUBER ** 2, 2 * HUBER * torch.sqrt(s) - HUBER ** 2, s).sum()
        return 0.5 * c

    def corrected(self, x):
        """Residual vector and Jacobian in the 12-dim local parametrization,
        the Huber corrector applied to the lidar blocks."""
        def flat(delta):
            xp = [quat_plus_linear(x[0], delta[0:3]), x[1] + delta[3:6],
                  quat_plus_linear(x[2], delta[6:9]), x[3] + delta[9:12]]
            lidar, other = self.residuals(xp)
            return torch.cat([r.reshape(-1) for r in lidar] + [other])

        zero = x[1].new_zeros(12)
        r = flat(zero)
        J = torch.func.jacfwd(flat)(zero)
        w = []
        for blk in self._lidar_r(x):
            s = blk.square().sum(-1)
            wb = torch.where(s > HUBER ** 2, torch.sqrt(HUBER / torch.sqrt(s)), torch.ones_like(s))
            w.append(wb[:, None].expand_as(blk).reshape(-1))
        n_other = r.shape[0] - sum(wb.shape[0] for wb in w)
        w = torch.cat(w + [r.new_ones(n_other)])
        return r * w, J * w[:, None]


def lm_solve(problem: _Problem, x, max_iterations: int = 6):
    """ceres::Solve with the TrustRegionMinimizer and LM strategy defaults
    (``oracles._ceres_lm_solve``), DENSE_QR on [J; diag(D)]."""
    prec = problem.prec
    radius, decrease_factor = 1e4, 2.0
    x = [v.clone() for v in x]
    cost = problem.total_cost(x)
    for _ in range(max_iterations):
        r, J = problem.corrected(x)
        g = prec.mm(J.T, r[:, None])[:, 0]
        if float(g.abs().max()) <= 1e-10:
            break
        D = torch.sqrt(torch.clamp((J * J).sum(0), 1e-6, 1e32) / radius)
        A = torch.cat([J, torch.diag(D)], 0)
        rhs = torch.cat([-r, r.new_zeros(12)])
        Qm, R = torch.linalg.qr(prec.operand(A))
        step = torch.linalg.solve_triangular(
            prec.operand(R), prec.mm(Qm.T, rhs[:, None]), upper=True)[:, 0]
        model_res = prec.mm(J, step[:, None])[:, 0]
        mcc = float(-(model_res * (r + model_res / 2.0)).sum())
        accepted = False
        if mcc > 0:
            x_new = [quat_plus(x[0], step[0:3]), x[1] + step[3:6],
                     quat_plus(x[2], step[6:9]), x[3] + step[9:12]]
            new_cost = problem.total_cost(x_new)
            rel = float(cost - new_cost) / mcc
            if rel > 1e-3:
                accepted = True
                radius = min(radius / max(1.0 / 3.0, 1.0 - (2.0 * rel - 1.0) ** 3), 1e16)
                decrease_factor = 2.0
                cost_change = float(cost - new_cost)
                x = [qnormalize(x_new[0]), x_new[1], qnormalize(x_new[2]), x_new[3]]
                converged = (abs(cost_change) <= 1e-6 * float(cost) or
                             float(torch.linalg.vector_norm(step)) <=
                             1e-8 * (float(torch.linalg.vector_norm(torch.cat(x))) + 1e-8))
                cost = new_cost
                if converged:
                    break
        if not accepted:
            radius /= decrease_factor
            decrease_factor *= 2.0
            if radius < 1e-32:
                break
    return x


def _plane(g: Dict[str, torch.Tensor], dt) -> Dict[str, torch.Tensor]:
    return {k: g[k].to(dt) for k in ("normal", "v1", "v2", "distance")}


def mapping(call: Dict[str, object], cfg: dict, prec: Precision) -> Dict[str, object]:
    """The call's map pose worked out from the program's state around it:
    {"q" (x, y, z, w), "t", "optimized"}."""
    dt = prec.dtype
    b, a = call["before"], call["after"]
    dev = b["t_md"].device

    def T(x):
        return x.to(device=dev, dtype=dt)

    q_md, t_md = xyzw(T(b["q_md"])), T(b["t_md"])
    q_odom, t_odom = xyzw(T(call["q_odom"])), T(call["t_odom"])
    q0 = qnormalize(qmul(q_md, q_odom))
    t0 = t_md + qrot(q_md, t_odom)
    ql0, tl0 = xyzw(T(b["q_w_last"])), T(b["t_w_last"])

    kf_count = int(b["kf_count"])
    cmap = local_map(b["kf_q"], b["kf_t"], b["kf_corner"], b["kf_corner_mask"], kf_count, t0,
                     cfg, cfg["map_corner_voxel"], prec)
    smap = local_map(b["kf_q"], b["kf_t"], b["kf_surf"], b["kf_surf_mask"], kf_count, t0, cfg,
                     cfg["map_surf_voxel"], prec)
    feats = {"corner": (T(a["last_corner"]), T(a["last_corner_conf"]), a["last_corner_mask"]),
             "corner_last": (T(b["last_corner"]), T(b["last_corner_conf"]), b["last_corner_mask"]),
             "surf": (T(a["last_surf"]), T(a["last_surf_conf"]), a["last_surf_mask"]),
             "surf_last": (T(b["last_surf"]), T(b["last_surf_conf"]), b["last_surf_mask"])}
    do_opt = (int(feats["corner"][2].sum()) > 10 and int(feats["surf"][2].sum()) > 50
              and cmap.shape[0] > 10 and smap.shape[0] > 50)
    if not do_opt:
        return {"q": q0, "t": t0, "optimized": False}

    imu = None
    if cfg["use_imu"] and cfg["map_update"]:
        dq = imu_rotation(*call["imu"], float(b["prev_stamp"]),
                          b["bg"].double().cpu().numpy()).to(device=dev, dtype=dt)
        d_ypr_deg = ypr_of(dq) * (180.0 / math.pi)
        imu_cov = 0.004 if float(torch.linalg.vector_norm(d_ypr_deg)) > 0.6 else 0.4
        ypr, ypr_l = T(a["imu_ypr_last"]), T(b["imu_ypr_last"])
        imu = (dq, imu_cov, (ypr[1], ypr[2]), (ypr_l[1], ypr_l[2]))
    grounds = None
    ground_on = (cfg["use_ground"] and cfg["map_update"] and int(a["gflag"]) == 0
                 and int(b["count"]) > 20 and bool(a["ground_last"]["valid"])
                 and bool(b["ground_last"]["valid"]))
    if ground_on:
        q_delta = xyzw(T(a["q_w_delta"]))
        q_wl, q_wl2 = ql0, xyzw(T(b["q_w_last2"]))
        grounds = (_plane(b["ground_last"], dt), _plane(a["ground_last"], dt),
                   qnormalize(qmul(qconj(q_delta), q_wl)), _plane(b["ground_last2"], dt),
                   qnormalize(qmul(qconj(q_delta), q_wl2)), q_wl2, T(b["t_w_last2"]))

    masks = {k: v[2] for k, v in feats.items()}
    feats = {k: (v[0], v[1]) for k, v in feats.items()}
    q, t = solve(feats, masks, cmap, smap, [q0, t0, ql0, tl0], imu, grounds,
                 cfg["map_opt_iterations"], prec)
    return {"q": q, "t": t, "optimized": True}


def solve(feats, masks, cmap, smap, x0, imu, grounds, outer: int, prec: Precision):
    """``oracles.reference_mapping_solve``, vectorized: ``outer`` rounds of
    association (frozen for the round) and a 6-iteration LM over the four
    poses.  Returns the current pose (q, t)."""
    x = list(x0)
    for _ in range(outer):
        assoc = {}
        for name, (pts, conf) in feats.items():
            q, t = (x[0], x[1]) if name in ("corner", "surf") else (x[2], x[3])
            corner = name.startswith("corner")
            assoc[name] = associate(pts, conf, masks[name], q, t, cmap if corner else smap,
                                    "corner" if corner else "surf", prec)
        x = lm_solve(_Problem(feats, assoc, imu, grounds, x, prec), x)
    return x[0], x[1]


# ---------------------------------------------------------------------------
# the keyframe decision
# ---------------------------------------------------------------------------


def keyframe_added(q_w: torch.Tensor, t_w: torch.Tensor, before: Dict[str, torch.Tensor],
                   cfg: dict) -> bool:
    """keyframeAddingDistance / keyframeAddingAngle against the last
    keyframe, on the map pose (x, y, z, w) the call returned."""
    count, K = int(before["kf_count"]), before["kf_t"].shape[0]
    if not cfg["map_update"] or count >= K:
        return False
    if count == 0:
        return True
    li = count - 1
    d_pos = float(torch.linalg.vector_norm(t_w.double() - before["kf_t"][li].double().to(t_w.device)))
    ypr_l = ypr_of(xyzw(before["kf_q"][li].double()).to(t_w.device))
    d_ang = float(wrap(ypr_l - ypr_of(q_w.double())).abs().max())
    return d_pos > cfg["keyframe_dist"] or d_ang > cfg["keyframe_angle"]


def keyframe_mismatch(call: Dict[str, object], cfg: dict) -> int:
    """0 when the store holds what the decision on the returned map pose
    asks: one new row (that pose, this call's features) or none."""
    b, a = call["before"], call["after"]
    q_map, t_map = xyzw(call["q_map"].double()), call["t_map"].double()
    added = int(a["kf_count"]) - int(b["kf_count"])
    want = keyframe_added(q_map, t_map, b, cfg)
    if added != int(want):
        return 1
    if want:
        i = int(b["kf_count"])
        same = (torch.equal(a["kf_t"][i].cpu(), call["t_map"].to(a["kf_t"].dtype).cpu())
                and torch.equal(a["kf_corner"][i], a["last_corner"][:a["kf_corner"].shape[1]])
                and torch.equal(a["kf_surf"][i], a["last_surf"][:a["kf_surf"].shape[1]]))
        return 0 if same else 1
    return 0


def plane_gaps(program: Dict[str, object], reference: Dict[str, object]) -> Tuple[float, float]:
    """(ground_angle_rad, ground_dist_m) of the program's ground plane; a
    plane valid on one side only reads inf."""
    if bool(program["valid"]) != bool(reference["valid"]):
        return math.inf, math.inf
    if not reference["valid"]:
        return 0.0, 0.0
    n_p = torch.as_tensor(np.asarray(program["normal"], np.float64))
    n_r = torch.as_tensor(reference["normal"])
    if float((n_p * n_r).sum()) < 0:
        n_r = -n_r
    ang = float(2.0 * torch.atan2(torch.linalg.vector_norm(n_p - n_r),
                                  torch.linalg.vector_norm(n_p + n_r)))
    return ang, abs(float(program["distance"]) - float(reference["distance"]))


def pose_gaps(q_map, t_map, ref: Dict[str, torch.Tensor]) -> Tuple[float, float]:
    """(map_pos_m, map_rot_rad) of the program's map pose (w, x, y, z)."""
    t = float((t_map.double().to(ref["t"].device) - ref["t"].double()).abs().max())
    r = angle_between(xyzw(q_map.double()).to(ref["q"].device), ref["q"])
    return t, r

