"""Long-session evidence run: the port of ``eval_longrun.py``.

    python -m rgc_slam_tpu_torch.tools.eval_longrun [--scans N] [--device cuda|cpu]

N_SCANS (2,000) scans on a closed course whose travel exceeds the
keyframe-store capacity (``CFG``, ``eval_longrun.py:34-44``) by more than
2x: the store must compact (not freeze), loops must still be detected and
accepted after saturation, and the keyframe-trajectory ATE must stay
bounded lap after lap.  A loop step runs every LOOP_EVERY scans; a
compaction is counted when ``kf_count`` drops across a loop step
(``models/loop._maybe_compact``).  ``run`` takes the scan count and the
configuration (``--scans`` cuts a run: the asserts need accepted loops past
``sat_scan``, about scan 640, so a cut keeps at least 800).  Prints one JSON
result line, then checks the three asserts of ``eval_longrun.py:108-113``
(``check``) and prints ``LONGRUN OK``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from ..config import TEST_CONFIG, SlamConfig
from ..io import synthetic
from ..models import loop as loop_mod
from ..models.slam import SlamState, slam_step
from ..utils.evaluation import ate_rmse
from . import common
from .eval import scan_inputs

N_SCANS = 2000
LOOP_EVERY = 5

CFG = dataclasses.replace(
    TEST_CONFIG,
    max_keyframes=256,          # 0.5 m gate -> ~128 m of travel capacity
    max_loops=32,
    loop_submap_halfwidth=25,
    max_loop_submap_points=8192,
    loop_icp_iterations=60,
    max_kf_corner=256, max_kf_surf=1024,
    max_sharp_total=1024, max_flat_total=2048,
    loop_fitness_thresh=0.25,   # test-density clouds; see PARITY.md
)


def longrun_sequence(n_scans: int) -> dict:
    """~5.3 laps of a 12 m-radius circle at 2,000 scans (0.2 m a scan;
    eval_longrun.py:50-54)."""
    return synthetic.generate_sequence(
        n_scans=n_scans, n_azimuth=360, seed=31, extent=26.0, radius=12.0,
        noise=0.004, motion_distortion=True, closes_loop=True,
        laps=n_scans * 0.2 / (2 * np.pi * 12.0), speed=2.0,
    )


def run(n_scans: int = N_SCANS, cfg: SlamConfig = CFG, device="cuda", seq=None,
        progress=print) -> dict:
    """The long run (eval_longrun.py:55-106) over ``longrun_sequence(n_scans)``
    (or ``seq``): the result record, with the scans of the accepted loops
    under ``accepts``."""
    dev = torch.device(device)
    seq = longrun_sequence(n_scans) if seq is None else seq
    state = SlamState.init(cfg, dev)
    lstate = loop_mod.LoopState.init(cfg, dev)

    est, accepts, compactions = [], [], 0
    common.sync(dev)
    t0 = time.perf_counter()
    for k in range(len(seq["scans"])):
        state, out = slam_step(state, *scan_inputs(seq, k, cfg, dev), cfg)
        est.append(out.t_map)
        if (k + 1) % LOOP_EVERY == 0:
            before = int(state.mapping.kf_count)
            state, lstate, info = loop_mod.loop_closure_step(state, lstate, cfg)
            if int(state.mapping.kf_count) < before:
                compactions += 1
            if bool(info.accepted):
                accepts.append(k)
        if (k + 1) % 500 == 0:
            progress(f"  scan {k+1}: kf={int(state.mapping.kf_count)} "
                     f"loops={int(lstate.loop_count)} "
                     f"compactions={compactions}")
    common.sync(dev)
    wall = time.perf_counter() - t0

    est = torch.stack(est).cpu().numpy()
    n = len(est)
    gt = np.stack([t for (_, t) in seq["poses"]])[:n]
    # per-quarter ATE: boundedness means the late quarters don't blow up
    quarters = [
        round(ate_rmse(est[i * n // 4:(i + 1) * n // 4],
                       gt[i * n // 4:(i + 1) * n // 4]), 3)
        for i in range(4)
    ]
    travel = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return {
        "n_scans": n,
        "travel_m": round(travel, 1),
        "capacity_travel_m": cfg.max_keyframes * cfg.keyframe_dist,
        "ate_per_quarter_m": quarters,
        "ate_full_m": round(ate_rmse(est, gt), 3),
        "n_loops": int(lstate.loop_count),
        "n_accepts": len(accepts),
        "last_accept_scan": accepts[-1] if accepts else None,
        "compactions": compactions,
        "kf_count_final": int(state.mapping.kf_count),
        "wall_s": round(wall, 1),
        "ms_per_scan": round(wall / n * 1e3, 1),
        "accepts": accepts,
    }


def check(result: dict, cfg: SlamConfig = CFG):
    """The three asserts of eval_longrun.py:108-113."""
    compactions, accepts, quarters = (result["compactions"], result["accepts"],
                                      result["ate_per_quarter_m"])
    sat_scan = int(cfg.max_keyframes * cfg.keyframe_dist / 0.2)  # ~scan 640
    assert compactions > 0, "store never compacted"
    assert accepts and accepts[-1] > sat_scan, "no loop accepted after saturation"
    assert max(quarters) < 4 * (min(quarters) + 0.05), "ATE not bounded"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=N_SCANS,
                    help=f"scans of the course (default {N_SCANS}; a cut keeps >= 800)")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    line = common.device_line(dev)
    print(f"device: {line}", flush=True)
    common.reset_knn()
    result = run(args.scans, CFG, dev, progress=lambda s: print(s, flush=True))
    print(json.dumps({**result, "device": line, "knn_launches": common.knn_launches()}))
    check(result, CFG)
    print("LONGRUN OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
