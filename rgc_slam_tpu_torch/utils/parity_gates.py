"""The port's stages held to the numpy oracles of ``utils/parity`` at the
gates of ``tests/test_parity_oracles.py`` (PARITY.md:232-242).

Each gate builds its problem with numpy from a fixed seed (the JAX test's
fixture, with the port's own math where that test used JAX's), runs the
port's stage on ``device`` and the oracle on the host, raises
``AssertionError`` when a limit is crossed, and returns the measured
deltas beside their limits.  ``tests/test_torch_parity_oracles.py`` runs
every gate on the CPU and ``chip_smoke.py`` phase 9b runs them on the card;
neither needs JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from ..config import TEST_CONFIG
from ..io import synthetic
from ..io.convert import cloud_from_scan_dict, rel_time_from_azimuth
from ..models.loop import LoopState, _pgo_solve, icp_point2point
from ..models.mapping import MappingState, scan_to_map_solve
from ..models.odometry import deskew_points, fusion_solve
from ..ops import factors as fac
from ..ops import features
from ..ops import imu as imu_ops
from ..ops import registration as reg
from ..ops import voxelhash as vh
from ..types import GroundPlane, ImuBatch
from . import math3d as m3
from . import parity

CFG = TEST_CONFIG
RAD2DEG = 180.0 / np.pi


def _limit(value: float, limit: float, what: str, inclusive: bool = False) -> dict:
    """``value`` below ``limit`` (or at it, ``inclusive``), else
    AssertionError: the pair, for the record."""
    if not (value <= limit if inclusive else value < limit):
        raise AssertionError(f"{what}: {value!r} {'above' if inclusive else 'not below'} {limit!r}")
    return {"value": float(value), "limit": float(limit)}


def _allclose_excess(got, want, rtol: float = 1e-7) -> float:
    """max(|got - want| - rtol |want|): what ``np.testing.assert_allclose``
    holds to ``atol``."""
    return float((np.abs(got - want) - rtol * np.abs(want)).max())


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _quat(ypr) -> np.ndarray:
    """wxyz float32 quaternion of [yaw, pitch, roll] (radians)."""
    return _np(m3.ypr_to_quat(torch.tensor(ypr, dtype=torch.float32)))


def _mat(q) -> np.ndarray:
    return _np(m3.quat_to_mat(torch.as_tensor(np.asarray(q, np.float32)))).astype(np.float64)


def _xyzw(q_wxyz) -> np.ndarray:
    q = np.asarray(q_wxyz, np.float64)
    return np.array([q[1], q[2], q[3], q[0]])


# ---------------------------------------------------------------------------
# (a) ground fit
# ---------------------------------------------------------------------------


def ground_fit(device) -> Dict:
    """The ground mark set exactly; the plane's normal within 1e-4 rad, its
    distance within 1e-4 m, its source within 1e-3."""
    seq = synthetic.generate_sequence(n_scans=2, n_azimuth=360, seed=11, extent=18.0,
                                      radius=8.0, noise=0.004, closes_loop=False, speed=2.0)
    worst = {"angle": 0.0, "dist": 0.0, "source": 0.0}
    for scan in seq["scans"][:2]:
        fx, dbg = features.extract_features(cloud_from_scan_dict(scan, CFG, device), CFG,
                                            debug=True)
        xyz = _np(dbg["xyz"]).astype(np.float64)
        oracle = parity.reference_ground_fit(
            xyz, np.linalg.norm(xyz, axis=-1), _np(dbg["ring_count"]),
            list(CFG.expected_ground_ranges), ground_scan_rings=CFG.ground_scan_rings,
            range_gate=CFG.ground_range_gate, lidar_height=CFG.lidar_height,
            ground_z_max=CFG.ground_z_max)
        _check(oracle["groundsize"] > 100, "oracle found no ground")
        n_diff = int(np.sum(oracle["marked"] != _np(dbg["ground_mask"])))
        _check(n_diff == 0, f"{n_diff} marked-point mismatches")
        g = fx.ground
        dot = abs(float(_np(g.normal).astype(np.float64) @ oracle["normal"]))
        worst["angle"] = max(worst["angle"], float(np.arccos(min(dot, 1.0))))
        worst["dist"] = max(worst["dist"], abs(float(g.distance) - float(oracle["distance"])))
        worst["source"] = max(worst["source"], abs(float(g.source) - float(oracle["source"])))
    return {"angle_rad": _limit(worst["angle"], 1e-4, "ground normal"),
            "distance_m": _limit(worst["dist"], 1e-4, "ground distance"),
            "source": _limit(worst["source"], 1e-3, "ground source")}


# ---------------------------------------------------------------------------
# (b) complementary filter
# ---------------------------------------------------------------------------


def _imu_stream(m=640, hz=200.0, seed=3):
    """Static for the first 340 samples, then slow rotation + accel."""
    rs = np.random.RandomState(seed)
    t = 100.0 + np.arange(m) / hz
    acc = np.tile([0.0, 0.0, 9.81], (m, 1))
    gyr = np.zeros((m, 3))
    dyn = np.arange(m) >= 340
    gyr[dyn, 0] = 0.04 * np.sin(np.arange(m)[dyn] / 40.0)
    gyr[dyn, 1] = 0.03 * np.cos(np.arange(m)[dyn] / 55.0)
    gyr[dyn, 2] = 0.05 * np.sin(np.arange(m)[dyn] / 70.0)
    acc[dyn, 0] += 0.2 * np.sin(np.arange(m)[dyn] / 30.0)
    acc += rs.normal(0, 0.01, (m, 3))
    gyr += rs.normal(0, 0.001, (m, 3))
    return t, acc, gyr


def complementary_filter(device) -> Dict:
    """Sample by sample after both median windows fill: roll and pitch
    within 2e-4 rad, yaw increments within 2e-5 rad."""
    t, acc, gyr = _imu_stream()
    oracle = parity.reference_complementary_filter(t, acc, gyr)
    state = imu_ops.ImuFilterState.init(device).replace(
        bias_ready=torch.tensor(True, device=device))      # isolate the filter from the warm-up
    batch = ImuBatch(t=_t(t, device), acc=_t(acc, device), gyr=_t(gyr, device),
                     mask=torch.ones(len(t), dtype=torch.bool, device=device))
    att = []
    for i in range(len(t)):
        one = ImuBatch(t=batch.t[i:i + 1], acc=batch.acc[i:i + 1], gyr=batch.gyr[i:i + 1],
                       mask=batch.mask[i:i + 1])
        state = imu_ops.complementary_filter_scan(state, one)
        att.append(torch.stack([state.roll, state.pitch, state.yaw]))
    rolls, pitches, yaws = _np(torch.stack(att)).T
    s = slice(320, None)
    return {"roll_rad": _limit(np.abs(rolls[s] - oracle["roll"][s]).max(), 2e-4, "roll"),
            "pitch_rad": _limit(np.abs(pitches[s] - oracle["pitch"][s]).max(), 2e-4, "pitch"),
            "yaw_increment_rad": _limit(
                np.abs(np.diff(yaws[s]) - np.diff(oracle["yaw"][s])).max(), 2e-5, "yaw")}


# ---------------------------------------------------------------------------
# (c) VGICP linearize, (d) the LM λ schedule
# ---------------------------------------------------------------------------


def _vgicp_problem(seed=7, n_src=256, n_tgt=1024):
    rs = np.random.RandomState(seed)
    tgt = rs.uniform(-6, 6, (n_tgt, 3)).astype(np.float32)
    tgt[:, 2] *= 0.3

    def covs(n):
        A = rs.normal(0, 0.1, (n, 3, 3)).astype(np.float32)
        return np.einsum("nij,nkj->nik", A, A) + 1e-3 * np.eye(3, dtype=np.float32)

    tgt_cov = covs(n_tgt)
    idx = rs.choice(n_tgt, n_src, replace=False)
    R = _mat(_quat([0.05, 0.02, -0.03])).astype(np.float32)
    t_true = np.array([0.3, -0.2, 0.1], np.float32)
    src = ((tgt[idx] - t_true) @ R).astype(np.float32)       # Rᵀ (x - t)
    src += rs.normal(0, 0.01, src.shape).astype(np.float32)
    return src, covs(n_src), tgt, tgt_cov


def _target_map(tgt, tgt_cov, res, device):
    return vh.build_gaussian_voxelmap(_t(tgt, device), _t(tgt_cov, device),
                                      torch.ones(len(tgt), dtype=torch.bool, device=device),
                                      res, CFG.max_voxels, probes=CFG.hash_probes)


def vgicp_linearize(device) -> Dict:
    """One VGICP linearization: the correspondence count exactly; H, b and
    the cost within 1e-3 relative."""
    src, src_cov, tgt, tgt_cov = _vgicp_problem()
    res = 1.0
    q = _quat([0.02, -0.01, 0.015])
    t = np.array([0.1, 0.05, -0.08], np.float32)
    vm = _target_map(tgt, tgt_cov, res, device)
    H_e, b_e, cost_e, n_e, _ = reg.vgicp_linearize(
        _t(src, device), _t(src_cov, device), torch.ones(len(src), dtype=torch.bool, device=device),
        vm, _t(q, device), _t(t, device), max_corr_dist=100.0)
    T = np.eye(4)
    T[:3, :3] = _mat(q)
    T[:3, 3] = t.astype(np.float64)
    H_o, b_o, cost_o, corr = parity.reference_vgicp_linearize(
        src, src_cov, parity.reference_gaussian_voxelmap(tgt, tgt_cov, res), T, res)
    _check(int(n_e) == len(corr), f"correspondences {int(n_e)} vs {len(corr)}")
    return {"n_corr": len(corr),
            "H_rel": _limit(np.abs(_np(H_e) - H_o).max() / np.abs(H_o).max(), 1e-3, "H"),
            "b_rel": _limit(np.abs(_np(b_e) - b_o).max() / np.abs(b_o).max(), 1e-3, "b"),
            "cost_rel": _limit(abs(float(cost_e) - cost_o) / abs(cost_o), 1e-3, "cost")}


def lm_schedule(device) -> Dict:
    """``lm_register(with_trace=True)`` against ``reference_lm_vgicp``: the
    outer count, accept flags and rejects exactly; λ after each outer
    iteration within 1e-3 relative; the final pose within 1e-4 of the
    float64 oracle's.

    The oracle runs in float64 and in float32 (its ``dtype``, which mirrors
    float32 accumulation for branchy schedules), and the engine's trace
    must equal one of the two exactly: ``oracle_dtype`` says which.  The
    CPU adds the cost sums as the float64 oracle decides.  On the card the
    same float32 sums add in another order, and this problem's last outer
    iteration improves the cost by 4.8e-6 on 1646 (float64 oracle), below
    one float32 ulp of the cost (1.2e-4): there the engine decides as the
    float32 oracle does (a reject that ends the loop).  At such a reject,
    which meets the convergence test, the C++ LM loop ends before it
    raises λ, and JAX's ``lm_register`` (and so the port) raises it by ν
    first: there the engine's λ is 2^rejects times the oracle's.  That λ
    is not used after the loop."""
    src, src_cov, tgt, tgt_cov = _vgicp_problem(seed=9)
    res = 1.0
    vm = _target_map(tgt, tgt_cov, res, device)
    cfg = dataclasses.replace(CFG, vgicp_max_corr_dist=100.0, neighbor_search=1)
    result, trace = reg.lm_register(
        _t(src, device), _t(src_cov, device), torch.ones(len(src), dtype=torch.bool, device=device),
        vm, m3.quat_identity(device), torch.zeros(3, device=device), cfg, with_trace=True)
    oracles = {dtype.__name__: parity.reference_lm_vgicp(
        src, src_cov, tgt, tgt_cov, res, np.eye(4), max_iterations=cfg.vgicp_max_iterations,
        lm_max_iterations=cfg.lm_max_inner, lm_init_lambda_factor=cfg.lm_init_lambda_factor,
        rotation_epsilon=cfg.rotation_epsilon, transformation_epsilon=cfg.translation_epsilon,
        dtype=dtype) for dtype in (np.float64, np.float32)}
    n_outer = int(trace["n_outer"])
    accs = [bool(a) for a in _np(trace["accepted"])[:n_outer]]
    rejs = [int(r) for r in _np(trace["n_rejects"])[:n_outer]]
    matched = [name for name, (_, tr) in oracles.items()
               if (accs, rejs) == ([s["accepted"] for s in tr], [s["n_rejects"] for s in tr])]
    _check(bool(matched), f"the trace (accepted {accs}, rejects {rejs}) is neither oracle's: " +
           "; ".join(f"{name} {[(s['accepted'], s['n_rejects']) for s in tr]}"
                     for name, (_, tr) in oracles.items()))
    trace_o = oracles[matched[0]][1]
    lam = _np(trace["lam_after"])
    lam_o = [s["lam_after"] * (2.0 ** s["n_rejects"] if s["converged"] and not s["accepted"]
                               else 1.0) for s in trace_o]
    lam_rel = max(abs(float(lam[k]) - lo) / max(abs(lo), 1e-12) for k, lo in enumerate(lam_o))
    T_o = oracles["float64"][0]
    return {"n_outer": n_outer, "accepted": accs, "n_rejects": rejs, "oracle_dtype": matched[0],
            "lambda_rel": _limit(lam_rel, 1e-3, "lambda trace", inclusive=True),
            "dR": _limit(np.abs(_mat(_np(result.q)) - T_o[:3, :3]).max(), 1e-4, "final R"),
            "dt_m": _limit(np.abs(_np(result.t).astype(np.float64) - T_o[:3, 3]).max(), 1e-4,
                           "final t")}


# ---------------------------------------------------------------------------
# (e) FourDOF residual + PGO
# ---------------------------------------------------------------------------


def fourdof_residual(device) -> Dict:
    """Ten random edges: translation rows within 1e-4, yaw within 1e-3 deg."""
    rs = np.random.RandomState(2)
    worst_t = worst_yaw = 0.0
    for _ in range(10):
        yaw_i, yaw_j = rs.uniform(-np.pi, np.pi, 2)
        pitch_i, roll_i = rs.uniform(-0.3, 0.3, 2)
        t_i, t_j = rs.uniform(-10, 10, (2, 3))
        t_meas = rs.uniform(-2, 2, 3)
        yaw_meas = rs.uniform(-np.pi, np.pi)
        r_e = _np(fac.fourdof_residual(
            _t(yaw_i, device), _t(t_i, device), _t(yaw_j, device), _t(t_j, device),
            _t(t_meas, device), _t(yaw_meas, device), _t(pitch_i, device),
            _t(roll_i, device))).astype(np.float64)
        r_o = parity.reference_fourdof_residual(
            yaw_i * RAD2DEG, t_i, yaw_j * RAD2DEG, t_j, t_meas, yaw_meas * RAD2DEG,
            pitch_i * RAD2DEG, roll_i * RAD2DEG)
        worst_t = max(worst_t, float(np.abs(r_e[:3] - r_o[:3]).max()))
        worst_yaw = max(worst_yaw, abs(r_e[3] * RAD2DEG - r_o[3]))
    return {"t": _limit(worst_t, 1e-4, "translation rows"),
            "yaw_deg": _limit(worst_yaw, 1e-3, "yaw row")}


def _loop_graph(K=24, seed=5):
    """Closed square course with injected odometric yaw drift."""
    rs = np.random.RandomState(seed)
    yaw_gt = np.linspace(0, 2 * np.pi, K, endpoint=False)
    t_gt = np.stack([8 * np.cos(yaw_gt), 8 * np.sin(yaw_gt), 0.02 * rs.randn(K)], axis=1)
    drift = np.cumsum(np.full(K, 0.004))
    yaw = yaw_gt + drift
    t = t_gt.copy()
    for k in range(1, K):
        Rk = parity._ypr2R_deg(np.array([drift[k - 1] * RAD2DEG, 0, 0]))
        t[k] = t[k - 1] + Rk @ (t_gt[k] - t_gt[k - 1])
    pitch = rs.uniform(-0.05, 0.05, K)
    roll = rs.uniform(-0.05, 0.05, K)
    ypr = np.stack([yaw, pitch, roll], axis=1)
    ki, kj = K - 1, 1
    R_j = parity._ypr2R_deg(np.array([yaw_gt[kj] * RAD2DEG, pitch[kj] * RAD2DEG,
                                      roll[kj] * RAD2DEG]))
    t_rel = R_j.T @ (t_gt[ki] - t_gt[kj])
    return ypr, t, [(ki, kj, t_rel, yaw_gt[ki] - yaw_gt[kj])]


def pgo_solve(device) -> Dict:
    """The 4-DoF PGO on a drifted closed course: keyframe positions within
    5e-3 m, yaws within 5e-4 rad; the graph moved by more than 5 cm."""
    ypr, t, loops = _loop_graph()
    K = len(ypr)
    oracle = parity.reference_pgo_solve(ypr, t, loops)
    ms = MappingState.init(CFG, device)
    kf_q, kf_t = ms.kf_q.clone(), ms.kf_t.clone()
    kf_q[:K] = m3.ypr_to_quat(_t(ypr, device))
    kf_t[:K] = _t(t, device)
    ms = ms.replace(kf_q=kf_q, kf_t=kf_t, kf_count=torch.tensor(K, dtype=torch.int32,
                                                                 device=device))
    ki, kj, t_rel, rel_yaw = loops[0]
    ls = LoopState.init(CFG, device)
    fields = dict(loop_i=ki, loop_j=kj, loop_t=t_rel, loop_yaw=rel_yaw,
                  loop_pitch_j=ypr[kj, 1], loop_roll_j=ypr[kj, 2])
    for name, value in fields.items():
        arr = getattr(ls, name).clone()
        arr[0] = torch.as_tensor(np.asarray(value), dtype=arr.dtype, device=device)
        ls = ls.replace(**{name: arr})
    ls = ls.replace(loop_count=torch.tensor(1, dtype=torch.int32, device=device))
    out = _pgo_solve(ms, ls, CFG)
    t_e = _np(out.kf_t[:K]).astype(np.float64)
    yaw_e = _np(m3.quat_to_ypr(out.kf_q[:K])[:, 0]).astype(np.float64)
    moved = float(np.abs(t_e - t).max())
    _check(moved > 0.05, f"the PGO moved the graph by {moved} m only")
    return {"moved_m": moved,
            "dt_m": _limit(np.abs(t_e - oracle["t"]).max(), 5e-3, "keyframe positions"),
            "dyaw_rad": _limit(np.abs(np.angle(np.exp(1j * (yaw_e - oracle["yaw"])))).max(),
                               5e-4, "keyframe yaws")}


# ---------------------------------------------------------------------------
# (g) the two-pose scan-to-map solve
# ---------------------------------------------------------------------------


def _sensor_frame(p_world, q_wxyz, t):
    return (np.asarray(p_world) - np.asarray(t)) @ _mat(q_wxyz)


def _quat_mul(a, b) -> np.ndarray:
    return _np(m3.quat_mul(torch.as_tensor(np.asarray(a, np.float32)),
                           torch.as_tensor(np.asarray(b, np.float32))))


def _quat_rotate(q, v) -> np.ndarray:
    return _np(m3.quat_rotate(torch.as_tensor(np.asarray(q, np.float32)),
                              torch.as_tensor(np.asarray(v, np.float32))))


def _conj(q) -> np.ndarray:
    return np.asarray(q, np.float32) * np.array([1, -1, -1, -1], np.float32)


def _mapping_fixture(seed=17):
    """A keyframe map of vertical edges, blobs, clean and bumpy planes, and
    two feature scans with known poses, every gate far from its boundary."""
    rs = np.random.RandomState(seed)
    lines = []
    for cx, cy in rs.uniform(-12, 12, (10, 2)):
        z = np.arange(-1.0, 2.0, 0.07)
        pts = np.stack([np.full_like(z, cx), np.full_like(z, cy), z], 1)
        lines.append(pts + rs.normal(0, 0.004, pts.shape))
    corner_map = np.concatenate(lines)
    for bx, by in rs.uniform(-12, 12, (6, 2)):      # eigen-gate rejects
        corner_map = np.concatenate([corner_map, [bx, by, 0.5] + rs.normal(0, 0.12, (30, 3))])

    def plane(n_pts, span, base, axes):
        uv = rs.uniform(-span, span, (n_pts, 2))
        return base + uv[:, :1] * axes[0] + uv[:, 1:] * axes[1]

    ex, ey, ez = np.eye(3)
    wall_x = plane(300, 6.0, np.array([14.0, 0, 0.5]), (ey, ez))
    wall_y = plane(300, 6.0, np.array([0, -10.0, 0.5]), (ex, ez))
    floor = plane(400, 10.0, np.array([0, 0, -1.5]), (ex, ey))
    bumpy = plane(150, 3.0, np.array([-8.0, 8.0, 0.5]), (ex, ez))
    bumpy[:, 1] += 0.45 * np.sin(3.0 * bumpy[:, 0]) * np.sin(3.0 * bumpy[:, 2])
    surf_map = np.concatenate([wall_x, wall_y, floor, bumpy])
    surf_map += rs.normal(0, 0.004, surf_map.shape)

    def scan_features(q_wxyz, t, n_c=40, n_s=80):
        picks = corner_map[rs.choice(len(corner_map) - 180, n_c - 12)]
        blob_picks = corner_map[-180:][rs.choice(180, 6)]
        far = rs.uniform(30, 40, (6, 3))
        cpts_w = np.concatenate([picks, blob_picks, far])
        cpts_w += rs.normal(0, 0.01, cpts_w.shape)
        surf_picks = np.concatenate([
            wall_x[rs.choice(len(wall_x), (n_s - 20) // 3)],
            wall_y[rs.choice(len(wall_y), (n_s - 20) // 3)],
            floor[rs.choice(len(floor), n_s - 20 - 2 * ((n_s - 20) // 3))],
            bumpy[rs.choice(len(bumpy), 12)],            # fit rejects
            rs.uniform(25, 35, (8, 3)),                  # distance rejects
        ])
        spts_w = surf_picks + rs.normal(0, 0.01, surf_picks.shape)
        return (_sensor_frame(cpts_w, q_wxyz, t), rs.uniform(0.6, 1.4, len(cpts_w)),
                _sensor_frame(spts_w, q_wxyz, t), rs.uniform(0.6, 1.4, len(spts_w)))

    q_true = _quat([0.3, 0.02, -0.03]).astype(np.float64)
    t_true = np.array([1.0, -0.5, 0.1])
    ql_true = _quat([0.27, 0.018, -0.025]).astype(np.float64)
    tl_true = np.array([0.8, -0.45, 0.09])
    cur = scan_features(q_true, t_true)
    last = scan_features(ql_true, tl_true)
    q0 = _quat_mul(_quat([0.008, -0.005, 0.006]), q_true).astype(np.float64)
    t0 = t_true + np.array([0.04, -0.03, 0.02])
    ql0 = _quat_mul(_quat([-0.004, 0.003, -0.002]), ql_true).astype(np.float64)
    tl0 = tl_true + np.array([-0.02, 0.015, -0.01])
    return dict(corner_map=corner_map, surf_map=surf_map, cur=cur, last=last, q0=q0, t0=t0,
                ql0=ql0, tl0=tl0, q_true=q_true, t_true=t_true, ql_true=ql_true,
                tl_true=tl_true)


def _edge_res(pt, pa, pb, var, q, t):
    lp = parity._quat_rotate_xyzw(q, pt) + t
    return np.cross(lp - pa, lp - pb) / np.linalg.norm(pa - pb) * var


def mapping_solve(device) -> Dict:
    """The two-pose scan-to-map solve: line / plane accept masks exactly at
    each outer iteration; each accepted factor's residual at the shared
    start pose within 1e-3 of its family's scale (edges up to sign); the
    final two poses within 1e-4; t within 0.3 x its start error of truth."""
    fx = _mapping_fixture()
    cfg = dataclasses.replace(CFG, degeneracy_thresh=0.0, map_opt_iterations=2)
    c_xyz, c_conf, s_xyz, s_conf = fx["cur"]
    cl_xyz, cl_conf, sl_xyz, sl_conf = fx["last"]
    # the IMU factors measure the true rotation and attitudes; the ground
    # distances are consistent with the true motion (float32, as the
    # engine sees them)
    delta_q_imu = _quat_mul(_conj(fx["ql_true"]), fx["q_true"]).astype(np.float64)
    imu_cov = 0.4
    ypr_cur = _np(m3.quat_to_ypr(_t(fx["q_true"], "cpu"))).astype(np.float64)
    ypr_last = _np(m3.quat_to_ypr(_t(fx["ql_true"], "cpu"))).astype(np.float64)
    q_hist = _quat([0.1, 0.0, 0.0]).astype(np.float64)
    t_lc_true = _quat_rotate(_conj(fx["ql_true"]), fx["t_true"] - fx["tl_true"])
    dtz = float(_quat_rotate(q_hist, t_lc_true)[2])
    g_last_d = 1.59
    q_w_last2 = _quat([0.24, 0.015, -0.02]).astype(np.float64)
    t_w_last2 = np.array([0.6, -0.4, 0.08])
    t_lc2_true = _quat_rotate(_conj(q_w_last2), fx["tl_true"] - t_w_last2)
    dtz2 = float(_quat_rotate(q_hist, t_lc2_true)[2])

    def gp(d):
        return GroundPlane(normal=_t([0, 0, 1], device), v1=_t([1, 0, 0], device),
                           v2=_t([0, 1, 0], device), distance=_t(d, device),
                           source=_t(0.0, device), valid=torch.tensor(True, device=device))

    g_last, g_cur, g_last2 = gp(g_last_d), gp(g_last_d - dtz), gp(g_last_d + dtz2)
    f = lambda a: _t(a, device)                                     # noqa: E731
    ones = lambda a: torch.ones(len(a), dtype=torch.bool, device=device)  # noqa: E731
    (q_e, t_e, ql_e, tl_e), _, dbg = scan_to_map_solve(
        f(fx["q0"]), f(fx["t0"]), f(fx["ql0"]), f(fx["tl0"]),
        f(c_xyz), f(c_conf), ones(c_xyz), f(cl_xyz), f(cl_conf), ones(cl_xyz),
        f(s_xyz), f(s_conf), ones(s_xyz), f(sl_xyz), f(sl_conf), ones(sl_xyz),
        f(fx["corner_map"]), ones(fx["corner_map"]), f(fx["surf_map"]), ones(fx["surf_map"]),
        f(delta_q_imu), f(imu_cov), f(1.0), f(ypr_cur), f(ypr_last),
        g_last, g_cur, g_last2, f(q_w_last2), f(t_w_last2), f(q_hist), f(q_hist), f(1.0),
        f(1.0), None, cfg, debug=True)

    gdict = lambda g: {k: _np(getattr(g, k)).astype(np.float64)   # noqa: E731
                       for k in ("normal", "v1", "v2")} | {"distance": float(g.distance)}
    oracle = parity.reference_mapping_solve(
        c_xyz, c_conf, s_xyz, s_conf, cl_xyz, cl_conf, sl_xyz, sl_conf,
        fx["corner_map"], fx["surf_map"], _xyzw(fx["q0"]), fx["t0"], _xyzw(fx["ql0"]), fx["tl0"],
        delta_q_imu=_xyzw(delta_q_imu), imu_cov=imu_cov,
        imu_pr=(ypr_cur[1], ypr_cur[2]), imu_pr_last=(ypr_last[1], ypr_last[2]),
        grounds=(gdict(g_last), gdict(g_cur), _xyzw(q_hist), gdict(g_last2), _xyzw(q_hist),
                 _xyzw(q_w_last2), t_w_last2),
        outer_iters=cfg.map_opt_iterations)

    worst_rel = 0.0
    for outer in range(cfg.map_opt_iterations):
        o = oracle["outer"][outer]
        ec, ecl, pc, pcl, _ = dbg[outer]
        for name, corr, key in (("corner", ec, "corner_mask"), ("corner_last", ecl, "corner_last_mask"),
                                ("surf", pc, "surf_mask"), ("surf_last", pcl, "surf_last_mask")):
            got, want = _np(corr.w) > 0, o[key]
            n_diff = int((got != want).sum())
            _check(n_diff == 0, f"outer {outer} {name}: {n_diff} accept-mask mismatches")
            _check(int(want.sum()) > 10, f"outer {outer} {name}: the fixture accepted too few")
        x0 = o["x0"]
        assoc_c, assoc_cl, assoc_s, assoc_sl = o["assoc"]
        for corr, assoc, pts, conf, q, t in ((ec, assoc_c, c_xyz, c_conf, x0[0], x0[1]),
                                             (ecl, assoc_cl, cl_xyz, cl_conf, x0[2], x0[3])):
            # the line direction's sign is free: compare up to sign
            errs, scale = [], 0.0
            pa, pb = _np(corr.pa).astype(np.float64), _np(corr.pb).astype(np.float64)
            for i, rec in enumerate(assoc):
                if rec["accept"]:
                    r_o = _edge_res(pts[i], rec["pa"], rec["pb"], conf[i], q, t)
                    r_e = _edge_res(pts[i], pa[i], pb[i], conf[i], q, t)
                    errs.append(min(np.abs(r_e - r_o).max(), np.abs(r_e + r_o).max()))
                    scale = max(scale, np.abs(r_o).max())
            worst_rel = max(worst_rel, max(errs) / scale)
        for corr, assoc, pts, conf, q, t in ((pc, assoc_s, s_xyz, s_conf, x0[0], x0[1]),
                                             (pcl, assoc_sl, sl_xyz, sl_conf, x0[2], x0[3])):
            errs, scale = [], 0.0
            n_e, d_e = _np(corr.n).astype(np.float64), _np(corr.d).astype(np.float64)
            for i, rec in enumerate(assoc):
                if rec["accept"]:
                    lp = parity._quat_rotate_xyzw(q, pts[i]) + t
                    r_o = (rec["n"] @ lp + rec["neg_oa"]) * conf[i]
                    errs.append(abs((n_e[i] @ lp + d_e[i]) * conf[i] - r_o))
                    scale = max(scale, abs(r_o))
            worst_rel = max(worst_rel, max(errs) / scale)

    wxyz = lambda q: np.r_[q[3], q[:3]]                                 # noqa: E731
    d_truth = np.abs(_np(t_e).astype(np.float64) - fx["t_true"]).max()
    d_start = np.abs(fx["t0"] - fx["t_true"]).max()
    _check(d_truth < 0.3 * d_start, f"the solve left t {d_truth} m from truth")
    return {"residual_rel": _limit(worst_rel, 1e-3, "factor residuals"),
            "dR": _limit(np.abs(_mat(_np(q_e)) - _mat(wxyz(oracle["q"]))).max(), 1e-4, "R"),
            "dt_m": _limit(np.abs(_np(t_e) - oracle["t"]).max(), 1e-4, "t"),
            "dR_last": _limit(np.abs(_mat(_np(ql_e)) - _mat(wxyz(oracle["ql"]))).max(), 1e-4,
                              "R_last"),
            "dt_last_m": _limit(np.abs(_np(tl_e) - oracle["tl"]).max(), 1e-4, "t_last")}


# ---------------------------------------------------------------------------
# (i) odometry factor fusion
# ---------------------------------------------------------------------------


def odometry_fusion(device) -> Dict:
    """Six random fusion problems (VGICP rotation + translation prior +
    ground + IMU rotation): the pose within 1e-4, and moved."""
    rs = np.random.RandomState(4)
    worst_R = worst_t = 0.0
    for trial in range(6):
        q_l = _quat(rs.uniform(-0.05, 0.05, 3).astype(np.float32)).astype(np.float64)
        t_l = rs.uniform(-0.3, 0.3, 3)
        t_l[0] += 0.2
        fitness = float(rs.uniform(0.05, 0.6))
        imu_cov = float(rs.uniform(0.05, 0.9))
        dq_pert = _quat(rs.uniform(-0.01, 0.01, 3).astype(np.float32))
        delta_q_imu = _quat_mul(dq_pert, q_l).astype(np.float64)
        q_hist = _quat(rs.uniform(-0.2, 0.2, 3).astype(np.float32)).astype(np.float64)
        g_last_d = 0.56 + rs.uniform(-0.02, 0.02)
        dtz = float(_quat_rotate(q_hist, t_l)[2])
        g_cur_d = g_last_d - dtz + rs.uniform(-0.002, 0.002)

        def gp(d):
            return GroundPlane(normal=_t([0, 0, 1], device), v1=_t([1, 0, 0], device),
                               v2=_t([0, 1, 0], device), distance=_t(d, device),
                               source=_t(0.0, device), valid=torch.tensor(True, device=device))

        q_e, t_e = fusion_solve(_t(q_l, device), _t(t_l, device), _t(fitness, device),
                                gp(g_last_d), gp(g_cur_d), _t(q_hist, device),
                                _t(delta_q_imu, device), _t(imu_cov, device), _t(1.0, device),
                                _t(1.0, device))
        plane = {"normal": np.array([0.0, 0, 1]), "v1": np.array([1.0, 0, 0]),
                 "v2": np.array([0.0, 1, 0])}
        o = parity.reference_odometry_fusion(
            _xyzw(q_l), t_l, fitness,
            ground=(dict(plane, distance=g_last_d),
                    dict(plane, distance=float(np.float32(g_cur_d))), _xyzw(q_hist)),
            delta_q_imu=_xyzw(delta_q_imu), imu_cov=imu_cov)
        worst_R = max(worst_R, float(np.abs(_mat(_np(q_e)) - _mat(np.r_[o["q"][3], o["q"][:3]])).max()))
        worst_t = max(worst_t, float(np.abs(_np(t_e).astype(np.float64) - o["t"]).max()))
        _check(np.abs(_np(t_e).astype(np.float64) - t_l).max() > 1e-5,
               f"trial {trial}: the solve did not move")
    return {"dR": _limit(worst_R, 1e-4, "fused R"), "dt_m": _limit(worst_t, 1e-4, "fused t")}


# ---------------------------------------------------------------------------
# (h) loop-closure ICP
# ---------------------------------------------------------------------------


def _submap_points(seed, n, drop_box=False):
    """Structured submap: walls + floor + a box, 2 cm noise."""
    rs = np.random.RandomState(seed)
    ex, ey, ez = np.eye(3)

    def plane(n_pts, span, base, axes):
        uv = rs.uniform(-span, span, (n_pts, 2))
        return base + uv[:, :1] * axes[0] + uv[:, 1:] * axes[1]

    parts = [plane(n // 4, 5.0, np.array([9.0, 0, 1.5]), (ey, ez)),
             plane(n // 4, 5.0, np.array([0, -7.0, 1.5]), (ex, ez)),
             plane(n // 4, 7.0, np.array([0, 0, 0.0]), (ex, ey))]
    if not drop_box:
        parts.append(plane(n - 3 * (n // 4), 1.2, np.array([3.0, 4.0, 1.0]), (ex + 0.3 * ey, ez)))
    else:
        parts.append(plane(n - 3 * (n // 4), 1.2, np.array([-4.0, 2.0, 1.0]), (ey - 0.2 * ex, ez)))
    pts = np.concatenate(parts)
    return pts + rs.normal(0, 0.02, pts.shape)


def _drifted(pts, yaw, t, seed=0):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    rs = np.random.RandomState(seed + 100)
    return pts @ R.T + np.asarray(t) + rs.normal(0, 0.02, pts.shape)


def loop_icp(device) -> Dict:
    """Two true revisits and one other place: accept / reject at the 0.1
    fitness gate as the oracle and as expected; on accepted pairs R within
    2e-3, t within 5e-3 m, fitness within 2% of the oracle's."""
    max_corr, gate = 14.0, 0.1
    cases = [((0.03, [0.3, -0.2, 0.05]), 0, True), ((0.10, [0.8, 0.5, -0.1]), 0, True),
             ((0.02, [0.1, 0.1, 0.0]), 7, False)]
    worst = {"dR": 0.0, "dt": 0.0, "fit": 0.0}
    fits = []
    for k, ((yaw, t), tgt_seed, expect) in enumerate(cases):
        tgt = _submap_points(21 + tgt_seed, 3072, drop_box=tgt_seed != 0)
        src = _drifted(_submap_points(21, 512), yaw, t, seed=k)
        q_e, t_e, fit_e, _ = icp_point2point(
            _t(src, device), torch.ones(len(src), dtype=torch.bool, device=device),
            _t(tgt, device), torch.ones(len(tgt), dtype=torch.bool, device=device),
            max_corr=torch.tensor(max_corr, device=device), iterations=CFG.loop_icp_iterations)
        o = parity.reference_loop_icp(src, tgt, max_corr)
        fits.append([float(fit_e), o["fitness"]])
        _check((float(fit_e) < gate) == (o["fitness"] < gate) == expect,
               f"case {k}: fitness {float(fit_e)} vs oracle {o['fitness']}, expected {expect}")
        if expect:
            worst["dR"] = max(worst["dR"], float(np.abs(_mat(_np(q_e)) - o["T"][:3, :3]).max()))
            worst["dt"] = max(worst["dt"], float(np.abs(_np(t_e) - o["T"][:3, 3]).max()))
            worst["fit"] = max(worst["fit"], abs(float(fit_e) - o["fitness"]) / o["fitness"])
    return {"fitness": fits, "dR": _limit(worst["dR"], 2e-3, "ICP R"),
            "dt_m": _limit(worst["dt"], 5e-3, "ICP t"),
            "fitness_rel": _limit(worst["fit"], 0.02, "ICP fitness")}


# ---------------------------------------------------------------------------
# (f) azimuth -> relative sweep time, and deskew
# ---------------------------------------------------------------------------


def _sweep_xyz(n, revs, start_deg, rng):
    """Clockwise sweep of ``revs`` revolutions from ``start_deg``, jittered."""
    az = np.deg2rad(start_deg) + np.linspace(0.0, revs * 2 * np.pi, n)
    az += rng.normal(0.0, 1e-3, n)
    r = rng.uniform(3.0, 40.0, n)
    return np.stack([r * np.cos(-az), r * np.sin(-az), rng.uniform(-1.0, 2.0, n)], 1)


def rel_time(device) -> Dict:
    """``io.convert.rel_time_from_azimuth`` (host numpy, so ``device`` is
    not used) against the halfPassed machine over under / over-revolution
    sweeps from four start angles: within 2e-5, first point at 0, last
    within 0.15 of 1."""
    rng = np.random.default_rng(42)
    worst = 0.0
    for revs in (1.0, 0.97, 1.05):
        for start in (0.0, 37.0, 181.0, 270.0):
            xyz = _sweep_xyz(720, revs, start, rng)
            got = rel_time_from_azimuth(xyz)
            worst = max(worst, _allclose_excess(got, parity.reference_rel_time(xyz)))
            _check(abs(got[0]) < 1e-6 and abs(got[-1] - 1.0) < 0.15,
                   f"endpoints {got[0]}, {got[-1]} at revs={revs} start={start}")
    return {"rel_time": _limit(worst, 2e-5, "rel_time", inclusive=True)}


def deskew(device) -> Dict:
    """``deskew_points`` against adjustDistortion on Eigen's linear slerp
    branch, a typical rotation and a large negative-w one: within 1e-4 m."""
    local = np.random.default_rng(1234)
    n = 257
    worst = {}
    for mag, label in ((1e-9, "linear branch"), (0.02, "typical"), (2.9, "large")):
        axis = local.standard_normal(3)
        axis /= np.linalg.norm(axis)
        q = np.zeros(4)
        q[0] = np.cos(mag / 2)
        q[1:] = np.sin(mag / 2) * axis
        if mag > 2.0:
            q = -q                       # Eigen slerp's d < 0 path
        t = local.standard_normal(3) * 0.5
        xyz = local.standard_normal((n, 3)) * 30.0
        rel = local.uniform(0.0, 1.0, n)
        ring = local.integers(0, 16, n)
        want = parity.reference_deskew(xyz, ring.astype(np.float64) + 0.1 * rel, q, t,
                                       scan_period=0.1)
        got = _np(deskew_points(_t(xyz, device), _t(rel, device), _t(q, device), _t(t, device)))
        worst[label] = _limit(_allclose_excess(got, want), 1e-4, f"deskew {label}",
                              inclusive=True)
    return worst


GATES: Dict[str, Callable[[object], Dict]] = {
    "ground_fit": ground_fit, "complementary_filter": complementary_filter,
    "vgicp_linearize": vgicp_linearize, "lm_schedule": lm_schedule,
    "fourdof_residual": fourdof_residual, "pgo_solve": pgo_solve,
    "mapping_solve": mapping_solve, "odometry_fusion": odometry_fusion,
    "loop_icp": loop_icp, "rel_time": rel_time, "deskew": deskew,
}
