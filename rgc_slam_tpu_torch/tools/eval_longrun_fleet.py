"""Fleet long-session soak: the port of ``eval_longrun_fleet.py``.

    RGC_FLEET_B=32 RGC_FLEET_SCANS=2000 RGC_FLEET_SEEDS=4 RGC_FLEET_KF=256 \\
        python -m rgc_slam_tpu_torch.tools.eval_longrun_fleet [--device cuda|cpu]

The B=1 long run's guarantees at fleet scale: B robots, N_SCANS scans each,
loop closure + PGO every LOOP_EVERY scans with the loop-aware keyframe
compaction of ``parallel.fleet.fleet_loop_step``, asserting
(``eval_longrun_fleet.py:170-181``, unchanged):

  * no NaN anywhere in the trajectory;
  * no capacity freeze: every robot compacts its store at least once;
  * every robot closes loops, and loops are still accepted after the last
    robot's store first saturates;
  * bounded error: the worst robot's per-quarter keyframe ATE stays within
    4x of its best quarter.

Inputs: N_SEEDS distinct synthetic worlds tiled over B robots, plus
independent per-robot per-scan point noise (5 mm) drawn on the device from
a ``torch.Generator`` seeded 7 (``tools/bench_inputs.perturb``).  The
environment names, defaults and CFG are the original's
(``eval_longrun_fleet.py:42-66``); a cut run shrinks RGC_FLEET_KF with
RGC_FLEET_SCANS (saturation lands near scan 2.5 x RGC_FLEET_KF).  The
trajectory, keyframe counts and accept flags stay on the device until the
run ends.  Prints one JSON result line, then ``FLEET LONGRUN OK``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from ..config import TEST_CONFIG, SlamConfig
from ..io import synthetic
from ..io.convert import cloud_from_scan_dict, imu_from_interval
from ..parallel import fleet
from ..types import tree_map, tree_stack
from ..utils import graph
from ..utils.evaluation import ate_rmse
from . import common
from .bench_inputs import perturb, tile

B = int(os.environ.get("RGC_FLEET_B", 32))
N_SCANS = int(os.environ.get("RGC_FLEET_SCANS", 2000))
N_SEEDS = int(os.environ.get("RGC_FLEET_SEEDS", 4))
# Keyframe capacity: saturation (and thus compaction + post-saturation loop
# accepts) must occur inside the run.  Travel is ~0.2 m/scan, the keyframe
# gate 0.5 m, so saturation lands near scan KF*2.5.
KF_CAP = int(os.environ.get("RGC_FLEET_KF", 256))
LOOP_EVERY = 5
NOISE_SEED = 7


def fleet_config(kf_cap: int = KF_CAP) -> SlamConfig:
    return dataclasses.replace(
        TEST_CONFIG,
        max_keyframes=kf_cap,       # 0.5 m gate -> kf_cap/2 m travel capacity
        max_loops=32,
        loop_submap_halfwidth=25,
        max_loop_submap_points=8192,
        loop_icp_iterations=60,
        max_kf_corner=256, max_kf_surf=1024,
        max_sharp_total=1024, max_flat_total=2048,
        loop_fitness_thresh=0.25,   # test-density clouds; see PARITY.md
        inline_compaction=False,    # the fleet compacts in fleet_loop_step
    )


CFG = fleet_config()


def fleet_sequences(n_scans: int, n_seeds: int):
    return [
        synthetic.generate_sequence(
            n_scans=n_scans, n_azimuth=360, seed=31 + s, extent=26.0,
            radius=12.0, noise=0.004, motion_distortion=True,
            closes_loop=True, laps=n_scans * 0.2 / (2 * np.pi * 12.0),
            speed=2.0,
        )
        for s in range(n_seeds)
    ]


def run(n_robots: int = B, n_scans: int = N_SCANS, n_seeds: int = N_SEEDS,
        cfg: SlamConfig = CFG, device="cuda", progress=print) -> dict:
    """The soak (eval_longrun_fleet.py:72-168): the result record, with the
    per-robot arrays the asserts read under ``arrays``."""
    dev = torch.device(device)
    n_seeds = min(n_seeds, n_robots)
    reps = -(-n_robots // n_seeds)
    progress(f"generating {n_seeds} x {n_scans}-scan worlds (B={n_robots}, tile x{reps})")
    seqs = fleet_sequences(n_scans, n_seeds)
    n = min(len(s["scans"]) for s in seqs)
    gen = torch.Generator(device=dev).manual_seed(NOISE_SEED)

    states = fleet.fleet_init(cfg, n_robots, dev)
    lstates = fleet.fleet_loop_init(cfg, n_robots, dev)
    fstep = graph.CompiledStep(functools.partial(fleet.fleet_step, cfg=cfg))
    est, kf_after_step, loop_steps = [], [], []
    common.sync(dev)
    t0 = time.perf_counter()
    for k in range(n):
        clouds, imus, stamps = [], [], []
        for s in range(n_seeds):
            clouds.append(cloud_from_scan_dict(seqs[s]["scans"][k], cfg, dev))
            t_imu, acc, gyr = seqs[s]["imu"][k]
            imus.append(imu_from_interval(t_imu, acc, gyr, cfg.max_imu, dev))
            stamps.append(seqs[s]["stamps"][k])
        cb = perturb(tree_map(lambda a: tile(a, reps, n_robots), tree_stack(clouds)), gen)
        ib = tree_map(lambda a: tile(a, reps, n_robots), tree_stack(imus))
        sb = tile(torch.tensor(stamps, dtype=torch.float32, device=dev), reps, n_robots)

        states, outs = fstep(states, cb, ib, sb)
        est.append(outs.t_map)
        kf_now = states.mapping.kf_count.clone()
        if (k + 1) % LOOP_EVERY == 0:
            states, lstates, info = fleet.fleet_loop_step(states, lstates, cfg)
            loop_steps.append((k, kf_now, states.mapping.kf_count.clone(), info.accepted))
            kf_now = states.mapping.kf_count.clone()
        kf_after_step.append(kf_now)
        if (k + 1) % 250 == 0:
            kf = kf_now.cpu().numpy()
            progress(f"  scan {k+1}/{n}: kf[min..max]={kf.min()}..{kf.max()} "
                     f"loops_total={int(lstates.loop_count.sum())} "
                     f"({time.perf_counter()-t0:.0f}s)")
    common.sync(dev)
    wall = time.perf_counter() - t0

    est = torch.stack(est).cpu().numpy()                      # [n, B, 3]
    kf_seen = torch.stack(kf_after_step).cpu().numpy()        # [n, B]
    compactions = np.zeros(n_robots, np.int64)
    last_accept = np.full(n_robots, -1, np.int64)
    for k, before, after, accepted in loop_steps:
        compactions += after.cpu().numpy() < before.cpu().numpy()
        last_accept = np.where(accepted.cpu().numpy(), k, last_accept)
    sat = kf_seen >= cfg.max_keyframes - 20
    saturated_at = np.where(sat.any(0), sat.argmax(0), -1)

    # per-robot, per-quarter keyframe ATE vs its world's ground truth
    quarters = np.zeros((n_robots, 4))
    full_ate = np.zeros(n_robots)
    for b in range(n_robots):
        gt = np.stack([t for (_, t) in seqs[b % n_seeds]["poses"]])[:n]
        for i in range(4):
            sl = slice(i * n // 4, (i + 1) * n // 4)
            quarters[b, i] = ate_rmse(est[sl, b], gt[sl])
        full_ate[b] = ate_rmse(est[:, b], gt)

    loops_per_robot = lstates.loop_count.cpu().numpy()
    return {
        "robots": n_robots,
        "n_scans": n,
        "distinct_worlds": n_seeds,
        "capacity_travel_m": cfg.max_keyframes * cfg.keyframe_dist,
        "ate_full_m_minmax": [round(float(full_ate.min()), 3),
                              round(float(full_ate.max()), 3)],
        "ate_per_quarter_m_worstrobot": [
            round(float(quarters[:, i].max()), 3) for i in range(4)
        ],
        "loops_per_robot_minmax": [int(loops_per_robot.min()),
                                   int(loops_per_robot.max())],
        "compactions_per_robot_minmax": [int(compactions.min()),
                                         int(compactions.max())],
        "first_saturation_scan": int(saturated_at.min()),
        "last_accept_scan_minmax": [int(last_accept.min()),
                                    int(last_accept.max())],
        "nan_found": bool(~np.isfinite(est).all()),
        "wall_s": round(wall, 1),
        "ms_per_fleet_step": round(wall / n * 1e3, 1),
        "arrays": {"est": est, "compactions": compactions, "loops_per_robot": loops_per_robot,
                   "saturated_at": saturated_at, "last_accept": last_accept,
                   "quarters": quarters},
    }


def check(result: dict):
    """The asserts of eval_longrun_fleet.py:170-181."""
    a = result["arrays"]
    est, compactions, loops_per_robot = a["est"], a["compactions"], a["loops_per_robot"]
    saturated_at, last_accept, quarters = a["saturated_at"], a["last_accept"], a["quarters"]
    assert np.isfinite(est).all(), "NaN in fleet trajectory"
    assert compactions.min() > 0, "some robot never compacted (freeze risk)"
    assert loops_per_robot.min() > 0, "some robot closed no loops"
    sat = int(saturated_at.max())
    assert last_accept.min() > sat, "no loop accepted after saturation"
    # boundedness: the worst late quarter stays within 4x the best quarter
    q = quarters.max(axis=0)
    assert q.max() < 4 * (q.min() + 0.05), f"fleet ATE not bounded: {q}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    line = common.device_line(dev)
    print(f"device: {line}", flush=True)
    common.reset_knn()
    result = run(B, N_SCANS, N_SEEDS, CFG, dev, progress=lambda s: print(s, flush=True))
    print(json.dumps({**{k: v for k, v in result.items() if k != "arrays"}, "device": line,
                      "knn_launches": common.knn_launches()}))
    check(result)
    print("FLEET LONGRUN OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
