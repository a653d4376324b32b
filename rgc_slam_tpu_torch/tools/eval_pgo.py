"""PGO scalability: the port of ``eval_pgo.py``.

    python -m rgc_slam_tpu_torch.tools.eval_pgo [--device cuda|cpu]

Measures ``models/loop._pgo_solve`` latency and solution quality at growing
keyframe capacities on a synthetic drifted loop: K ground-truth poses on a
circle, the estimate accumulates smooth yaw/translation drift, and one
loop closure ties the last keyframe back to the first (``make_graph``,
``eval_pgo.py:30-85``).  Reports the synchronized wall latency (median of
``reps`` solves after one warm-up), and the keyframe ATE against the ground
truth before and after the solve (``ate``, ``run_case``: ``eval_pgo.py:87-112``;
``run_case`` also returns both unrounded), for K in (512, 2048, 4096) at 128
CG iterations, as the same table.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from ..config import SlamConfig
from ..models.loop import LoopState, _pgo_solve
from ..models.mapping import MappingState
from ..utils import math3d as m3
from . import common


def make_graph(cfg: SlamConfig, K: int, drift_yaw: float = 2e-4,
               drift_t: float = 2e-3, seed: int = 0, device="cuda"):
    """Drifted circle with one loop closing the ring (GT pitch/roll = 0):
    (MappingState, LoopState, ground-truth positions [K, 3])."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    R = K * 0.5 / (2 * np.pi)          # 0.5 m keyframe spacing
    th = np.linspace(0, 2 * np.pi, K, endpoint=False)
    gt_t = np.stack([R * np.cos(th), R * np.sin(th), np.zeros(K)], axis=-1)
    gt_yaw = th + np.pi / 2.0

    # integrate drifted odometry: per-step yaw bias + translation noise
    est_yaw = np.zeros(K)
    est_t = np.zeros((K, 3))
    est_yaw[0], est_t[0] = gt_yaw[0], gt_t[0]
    for i in range(K - 1):
        dyaw = gt_yaw[i + 1] - gt_yaw[i] + drift_yaw
        Rw = np.array([
            [np.cos(est_yaw[i] - gt_yaw[i]), -np.sin(est_yaw[i] - gt_yaw[i]), 0],
            [np.sin(est_yaw[i] - gt_yaw[i]), np.cos(est_yaw[i] - gt_yaw[i]), 0],
            [0, 0, 1],
        ])
        step = Rw @ (gt_t[i + 1] - gt_t[i]) + drift_t * rng.standard_normal(3)
        est_yaw[i + 1] = est_yaw[i] + dyaw
        est_t[i + 1] = est_t[i] + step

    ms = MappingState.init(cfg, dev)
    Kc = cfg.max_keyframes
    ypr = np.zeros((K, 3), np.float32)
    ypr[:, 0] = est_yaw
    kf_q = ms.kf_q.clone()
    kf_q[:K] = m3.ypr_to_quat(torch.from_numpy(ypr).to(dev))
    kf_t = np.zeros((Kc, 3), np.float32)
    kf_t[:K] = est_t
    travel = np.zeros(Kc, np.float32)
    travel[:K] = 0.5 * np.arange(K)
    ms = ms.replace(
        kf_q=kf_q, kf_t=torch.from_numpy(kf_t).to(dev),
        kf_travel=torch.from_numpy(travel).to(dev),
        kf_count=torch.tensor(K, dtype=torch.int32, device=dev),
    )

    # one loop: latest (K-1) back to keyframe 0, measured from GT
    ls = LoopState.init(cfg, dev)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    q0 = m3.ypr_to_quat(f32([gt_yaw[0], 0.0, 0.0]))
    qn = m3.ypr_to_quat(f32([gt_yaw[-1], 0.0, 0.0]))
    q_rel = m3.quat_mul(m3.quat_conj(q0), qn)
    t_rel = m3.quat_rotate(m3.quat_conj(q0), f32(gt_t[-1] - gt_t[0]))
    loop_i, loop_j = ls.loop_i.clone(), ls.loop_j.clone()
    loop_t, loop_yaw = ls.loop_t.clone(), ls.loop_yaw.clone()
    loop_i[0], loop_j[0], loop_t[0] = K - 1, 0, t_rel
    loop_yaw[0] = m3.quat_to_ypr(q_rel)[0]
    ls = ls.replace(loop_i=loop_i, loop_j=loop_j, loop_t=loop_t, loop_yaw=loop_yaw,
                    loop_count=torch.tensor(1, dtype=torch.int32, device=dev))
    return ms, ls, gt_t


def ate(kf_t, gt_t, K):
    e = np.asarray(torch.as_tensor(kf_t).cpu())[:K] - gt_t
    return float(np.sqrt(np.mean(np.sum(e * e, axis=-1))))


def run_case(K: int, cg_iters: int, reps: int = 3, device="cuda"):
    dev = torch.device(device)
    cfg = SlamConfig(max_keyframes=K, max_kf_corner=8, max_kf_surf=8,
                     max_loops=8, pgo_cg_iters=cg_iters)
    ms, ls, gt_t = make_graph(cfg, K, device=dev)
    out = _pgo_solve(ms, ls, cfg)
    common.sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = _pgo_solve(ms, ls, cfg)
        common.sync(dev)
        times.append(time.perf_counter() - t0)
    before, after = ate(ms.kf_t, gt_t, K), ate(out.kf_t, gt_t, K)
    return {
        "K": K,
        "cg_iters": cg_iters,
        "latency_ms": round(statistics.median(times) * 1e3, 1),
        "ate_before_m": round(before, 3),
        "ate_after_m": round(after, 3),
        "ate_before_m_unrounded": before,
        "ate_after_m_unrounded": after,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    line = common.device_line(dev)
    print(f"device: {line}", flush=True)
    rows = []
    for K in (512, 2048, 4096):
        for cg in (128,):
            rows.append(run_case(K, cg, device=dev))
            print(rows[-1], flush=True)
    print()
    print(f"PGO on {line} (synchronized wall ms, median of 3 solves)")
    print("| K | cg_iters | latency (ms) | ATE before (m) | ATE after (m) |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['K']} | {r['cg_iters']} | {r['latency_ms']} | "
              f"{r['ate_before_m']} | {r['ate_after_m']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
