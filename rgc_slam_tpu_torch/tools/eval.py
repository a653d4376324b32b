"""Accuracy and speed of the port on the BASELINE.json configurations: the
port of ``eval.py``.

    python -m rgc_slam_tpu_torch.tools.eval [--quick] [--only GATES] [--out-dir DIR]
        [--device cuda|cpu]

Each configuration runs on the synthetic ground-truth world that matches
its stress profile, as in ``eval.py``:

  1.  16-ch + IMU + ground, no loop closure         (gate "1")
  1p. the same with ``imu_cov_mode="preint"``          ("1p")
  2.  16-ch full SLAM with loop closure (closed course) ("2")
  3.  degraded corridor, Huber and l1 mapping loss    ("3", "3l1")
  4.  64-beam lidar-only at 65536-point caps          ("4")
  5.  64 robots of one world through ``fleet_step``   ("5_fleet")
  5b. 4 robots on distinct closed courses with the fleet loop step, robot
      0 against its B=1 run                           ("5b")

What it keeps from ``eval.py``: ``BASE`` (``eval.py:35-46``),
``run_sequence`` (``:48-102``, the same result keys), the gates of
``--only`` (``:105-145``) and each gate's sequence and configuration
(``:159-380``; ``sequence`` and ``gate_config`` here).  What differs:

* it writes ``eval_results_torch.json`` and ``EVAL_TORCH.md`` into
  ``--out-dir`` (default: the working directory), never ``eval_results.json``
  or ``EVAL.md``; the header names the card and its power limit;
* ``--quick`` also runs 5b, over QUICK_5B_SCANS scans of each course (as
  config 2's quick run shortens its course); ``eval.py`` runs 5b only
  without ``--quick``;
* 5_fleet's note quotes no throughput: ``chip_smoke.py`` phase 6 measures
  the fleet of 128 robots at FLEET_CONFIG;
* ``run_sequence`` keeps every output on the device and synchronizes once
  after the last scan; the step's own host reads (early-exit loops,
  branches) stay inside the timed window.  Results add ``ms_per_scan``.
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

from ..config import FLEET_CONFIG, SlamConfig
from ..io import synthetic
from ..io.convert import cloud_from_scan_dict, imu_from_interval
from ..models import loop as loop_mod
from ..models.slam import SlamState, slam_step
from ..parallel import fleet
from ..types import tree_map, tree_stack
from ..utils import graph
from ..utils.evaluation import ate_rmse, rpe_rmse
from . import common

BASE = SlamConfig(
    max_points=16384, max_source_points=8192, max_voxels=16384,
    max_keyframes=512, max_kf_corner=512, max_kf_surf=2048,
    max_map_points=16384, max_loop_submap_points=16384,
    loop_icp_iterations=60,
    # the point-to-point fitness floor is the squared NN spacing of the
    # submap; at 0.2 m submap voxels the reference's own 0.1 acceptance
    # gate (RGC_mapping.cpp:156,2071) holds on full-density synthetic
    # worlds (eval.py:40-44)
    loop_submap_voxel=0.2, loop_fitness_thresh=0.1,
)

# gate -> the result keys that gate produces (eval.py:124-133)
GATES = {
    "1": ["1_full_pipeline_no_loop"],
    "1p": ["1p_preint_imu_cov"],
    "2": ["2_full_slam_loop"],
    "3": ["3_degraded_corridor"],
    "3l1": ["3l1_degraded_corridor_l1"],
    "4": ["4_synth64_lidar_only"],
    "5_fleet": ["5_fleet_64"],
    "5b": ["5b_fleet_full_slam_distinct"],
}
TABLE = ("1_full_pipeline_no_loop", "1p_preint_imu_cov", "2_full_slam_loop",
         "3_degraded_corridor", "3l1_degraded_corridor_l1", "4_synth64_lidar_only")
FLEET_B = 64                 # config 5's robots
FLEET_STEPS = 4
N_5B = 300                   # config 5b's scans per course (eval.py:316)
QUICK_5B_SCANS = 120         # with --quick: config 2's quick length
RESULTS = "eval_results_torch.json"
REPORT = "EVAL_TORCH.md"


def gate_config(gate: str) -> SlamConfig:
    """The configuration each gate runs (eval.py:172, 181, 197, 236, 247,
    264-267, 287, 311-313)."""
    cfg1 = dataclasses.replace(BASE, loop_closure_enable=False)
    return {
        "1": cfg1,
        "1p": dataclasses.replace(cfg1, imu_cov_mode="preint"),
        "2": BASE,
        "3": BASE,
        "3l1": dataclasses.replace(BASE, mapping_loss="l1"),
        "4": dataclasses.replace(BASE, n_scans=64, use_imu=False, use_ground=False,
                                 loop_closure_enable=False, max_points=65536),
        "5_fleet": FLEET_CONFIG,
        "5b": dataclasses.replace(BASE, inline_compaction=False, max_keyframes=256),
    }[gate]


def loop_every(gate: str) -> int:
    """Scans between loop steps: the product cadence for config 2 (and 5b's
    fleet), none elsewhere (eval.py:195-197)."""
    return gate_config(gate).loop_cadence if gate in ("2", "5b") else 0


def _yaw_R(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def corridor_sequence(n_leg: int) -> dict:
    """Config 3's drive (eval.py:208-241): a 70 m corridor with sparse
    alcoves, ``n_leg`` scans down it at 0.4 m a scan, a 180-degree turn in
    place over 25 scans, and ``n_leg`` scans back."""
    world3 = synthetic.corridor_world(length=70.0, width=8.0, alcove_spacing=24.0)
    poses3 = []
    for k in range(n_leg):                    # -25 -> +25
        poses3.append((np.eye(3), np.array([-25.0 + 0.4 * k, 0.0, 0.56])))
    x_turn = poses3[-1][1][0]
    for k in range(1, 26):                    # 180-deg turn in place
        th = np.pi * k / 25.0
        poses3.append((_yaw_R(th), np.array([x_turn, 0.0, 0.56])))
    for k in range(1, n_leg + 1):             # back to the start, reversed
        poses3.append((_yaw_R(np.pi), np.array([x_turn - 0.4 * k, 0.0, 0.56])))
    n3 = len(poses3)
    imu3 = synthetic.synthesize_imu(poses3, 0.1)
    rng3 = np.random.default_rng(23)
    return {
        "scans": [
            synthetic.cast_scan(world3, R, t, n_rings=16, n_azimuth=900, rng=rng3, noise=0.01)
            for (R, t) in poses3
        ],
        "imu": [imu3[max(k - 1, 0)] for k in range(n3)],
        "stamps": [0.1 * (k + 1) for k in range(n3)],
        "poses": poses3,
    }


def sequence(gate: str, quick: bool):
    """The sequence a gate runs (a list of the 4 courses for 5b), with the
    arguments of eval.py:166-171, 187-194, 208-241, 259-262, 278-281 and
    317-323."""
    if gate in ("1", "1p"):
        return synthetic.generate_sequence(
            n_scans=60 if quick else 400, n_azimuth=900, seed=21, extent=30.0,
            radius=12.0, noise=0.01, closes_loop=False, speed=2.0,
        )
    if gate == "2":
        return synthetic.generate_sequence(
            n_scans=120 if quick else 600, n_azimuth=900, seed=22, extent=26.0,
            radius=10.0, noise=0.01, closes_loop=True, laps=1.6,
        )
    if gate in ("3", "3l1"):
        return corridor_sequence(20 if quick else 125)
    if gate == "4":
        return synthetic.generate_sequence(
            n_scans=30 if quick else 300, n_rings=64, n_azimuth=900, seed=24,
            extent=45.0, radius=18.0, noise=0.01, closes_loop=False, speed=2.5,
        )
    if gate == "5_fleet":
        return synthetic.generate_sequence(
            n_scans=6, n_azimuth=900, seed=21, extent=30.0, radius=12.0,
            noise=0.01, closes_loop=False, speed=2.0,
        )
    if gate == "5b":
        return [
            synthetic.generate_sequence(
                n_scans=QUICK_5B_SCANS if quick else N_5B, n_azimuth=900, seed=40 + s,
                extent=26.0, radius=10.0, noise=0.01, closes_loop=True, laps=1.4,
            )
            for s in range(4)
        ]
    raise ValueError(f"unknown gate {gate!r}; valid gates: {sorted(GATES)}")


def scan_inputs(seq, k: int, cfg: SlamConfig, dev):
    t_imu, acc, gyr = seq["imu"][k]
    return (cloud_from_scan_dict(seq["scans"][k], cfg, dev),
            imu_from_interval(t_imu, acc, gyr, cfg.max_imu, dev),
            torch.tensor(seq["stamps"][k], dtype=torch.float32, device=dev))


def run_sequence(cfg: SlamConfig, seq: dict, loop_every: int = 0, device="cuda") -> dict:
    """``slam_step`` over every scan of ``seq`` (and ``loop_closure_step``
    after every ``loop_every``-th), all inputs staged on ``device`` first:
    the engine, not the host feed.  The step is compiled
    (``utils.graph.CompiledStep``: one CUDA graph replayed a scan on the
    card), as eval.py jits it.  Returns eval.py's result keys."""
    dev = torch.device(device)
    state = SlamState.init(cfg, dev)
    lstate = loop_mod.LoopState.init(cfg, dev)
    staged = [scan_inputs(seq, k, cfg, dev) for k in range(len(seq["scans"]))]
    step = graph.CompiledStep(functools.partial(slam_step, cfg=cfg))
    est_map, est_odo, loop_infos = [], [], []
    common.sync(dev)
    t0 = time.perf_counter()
    for k, (cloud, imu, stamp) in enumerate(staged):
        state, out = step(state, cloud, imu, stamp)
        est_map.append(out.t_map)
        est_odo.append(out.t_odom)
        if loop_every and (k + 1) % loop_every == 0:
            state, lstate, info = loop_mod.loop_closure_step(state, lstate, cfg)
            loop_infos.append((info.accepted, info.fitness))
    common.sync(dev)
    wall = time.perf_counter() - t0
    est_map = torch.stack(est_map).cpu().numpy()
    est_odo = torch.stack(est_odo).cpu().numpy()
    n_loops = int(lstate.loop_count)
    gt = np.stack([t for (_, t) in seq["poses"]])
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    # accepted-loop ICP fitness: evidence for the loop gate (eval.py:90-92)
    acc_fit = [float(f) for a, f in loop_infos if bool(a)]
    n = len(seq["scans"])
    return {
        "mapping_loss": cfg.mapping_loss,
        "loop_fitness_accepted_max": round(max(acc_fit), 4) if acc_fit else None,
        "loop_fitness_accepted_med": (
            round(float(np.median(acc_fit)), 4) if acc_fit else None
        ),
        "n_scans": n,
        "path_m": round(path_len, 1),
        "ate_map_m": round(ate_rmse(est_map, gt), 4),
        "ate_odom_m": round(ate_rmse(est_odo, gt), 4),
        "rpe_map_m": round(rpe_rmse(est_map, gt), 4),
        "n_loops": n_loops,
        "wall_s": round(wall, 1),
        "scans_per_sec": round(n / wall, 1),
        "ms_per_scan": round(wall / n * 1e3, 1),
    }


def run_fleet_64(seq: dict, device="cuda") -> dict:
    """Config 5 (eval.py:274-305): FLEET_B robots fed the same scans for
    FLEET_STEPS steps at FLEET_CONFIG; the robots' spread is ~0."""
    dev = torch.device(device)
    cfgF = gate_config("5_fleet")
    states = fleet.fleet_init(cfgF, FLEET_B, dev)
    fstep = graph.CompiledStep(functools.partial(fleet.fleet_step, cfg=cfgF))
    common.sync(dev)
    t0 = time.perf_counter()
    for k in range(FLEET_STEPS):
        batched = tree_map(lambda a: a.expand(FLEET_B, *a.shape).contiguous(),
                           scan_inputs(seq, k, cfgF, dev))
        states, outs = fstep(states, *batched)
    common.sync(dev)
    wall = time.perf_counter() - t0
    tm = outs.t_map.cpu().numpy()
    return {
        "robots": FLEET_B,
        "cross_robot_spread_m": float(np.abs(tm - tm[:1]).max()),
        "wall_s": round(wall, 1),
        "note": "fleet throughput: chip_smoke.py phase 6 (128 robots at FLEET_CONFIG)",
    }


def run_fleet_distinct(seqs, device="cuda") -> dict:
    """Config 5b (eval.py:307-380): the fleet step and the fleet loop step
    at the product cadence on distinct closed courses, each robot's ATE,
    and robot 0 against its B=1 run through the same fleet machinery."""
    dev = torch.device(device)
    cfg5 = gate_config("5b")
    n5 = min(len(s5["scans"]) for s5 in seqs)
    B5 = len(seqs)
    fstep = graph.CompiledStep(functools.partial(fleet.fleet_step, cfg=cfg5))

    def drive(streams):
        fstates = fleet.fleet_init(cfg5, len(streams), dev)
        flstates = fleet.fleet_loop_init(cfg5, len(streams), dev)
        est = []
        for k in range(n5):
            batch = [tree_stack(x) for x in zip(*(scan_inputs(s5, k, cfg5, dev) for s5 in streams))]
            fstates, fouts = fstep(fstates, *batch)
            est.append(fouts.t_map)
            if (k + 1) % cfg5.loop_cadence == 0:
                fstates, flstates, _ = fleet.fleet_loop_step(fstates, flstates, cfg5)
        common.sync(dev)
        return torch.stack(est).cpu().numpy(), flstates        # [T, B, 3]

    t0 = time.perf_counter()
    est5, flstates = drive(seqs)
    wall = time.perf_counter() - t0
    per_robot = [round(ate_rmse(est5[:, b], np.stack([t for (_, t) in seqs[b]["poses"]])), 4)
                 for b in range(B5)]
    est1, _ = drive(seqs[:1])
    gt0 = np.stack([t for (_, t) in seqs[0]["poses"]])
    ate_b1 = round(ate_rmse(est1[:, 0], gt0), 4)
    return {
        "robots": B5,
        "n_scans": n5,
        "loops_per_robot": [int(x) for x in flstates.loop_count.cpu()],
        "ate_map_m_per_robot": per_robot,
        "ate_map_m_b1_stream0": ate_b1,
        "fleet_vs_b1_ate_delta_m": round(abs(per_robot[0] - ate_b1), 4),
        "wall_s": round(wall, 1),
    }


def run_gate(gate: str, quick: bool, device="cuda", seq=None) -> dict:
    """{result key: result} of one gate (``seq``: its sequence, if made)."""
    seq = sequence(gate, quick) if seq is None else seq
    if gate == "5_fleet":
        result = run_fleet_64(seq, device)
    elif gate == "5b":
        result = run_fleet_distinct(seq, device)
    else:
        result = run_sequence(gate_config(gate), seq, loop_every(gate), device)
    return {GATES[gate][0]: result}


def report(results: dict, device_line: str) -> str:
    """EVAL_TORCH.md's generated part: eval.py's table (plus ms/scan) and
    notes."""
    lines = [
        "# EVAL_TORCH — the port's BASELINE config evaluation (synthetic ground-truth worlds)",
        "",
        f"Device: `{device_line}`; torch {torch.__version__}.  Full pipeline per scan "
        "(features → odometry → mapping, loop closure at the product cadence "
        "cfg.loop_cadence=10 scans where enabled), `python -m "
        "rgc_slam_tpu_torch.tools.eval`.  ATE/RPE after SE(3) alignment "
        "(evo convention).  ms/scan: wall time from the first step to one "
        "synchronize after the last, inputs staged on the device first; the "
        "step's own host reads stay inside it.",
        "",
        "| Config | scans | path (m) | loss | ATE map (m) | ATE odom (m) | RPE (m) | loops | ms/scan |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for name in TABLE:
        r = results.get(name)
        if r is None:          # --only rerun over a stale results file
            lines.append(f"| {name} | — | — | — | — | — | — | — | — |")
            continue
        lines.append(
            f"| {name} | {r['n_scans']} | {r['path_m']} | "
            f"{r.get('mapping_loss', 'huber')} | {r['ate_map_m']} | "
            f"{r['ate_odom_m']} | {r['rpe_map_m']} | {r['n_loops']} | {r['ms_per_scan']} |"
        )
    r5 = results.get("5_fleet_64", {"robots": "?", "cross_robot_spread_m": float("nan")})
    lines += [
        "",
        f"Fleet (config 5): {r5['robots']} robots fed the same scans, cross-robot "
        f"result spread {r5['cross_robot_spread_m']:.2e} m (identical inputs ⇒ ~0); "
        "the fleet's throughput is `chip_smoke.py` phase 6's number.",
        "",
    ]
    r5b = results.get("5b_fleet_full_slam_distinct")
    if r5b:
        lines += [
            f"Fleet full SLAM (config 5b): {r5b['robots']} robots on DISTINCT "
            f"closed courses over {r5b['n_scans']} scans with the vmapped loop "
            f"step at the product cadence — loops/robot {r5b['loops_per_robot']}, "
            f"per-robot ATE {r5b['ate_map_m_per_robot']} m, and robot 0 matches "
            f"its B=1 run to {r5b['fleet_vs_b1_ate_delta_m']} m ATE delta.",
            "",
        ]
    r2 = results.get("2_full_slam_loop", {})
    lines += [
        f"Loop-gate note: the reference acceptance gate 0.1 (RGC_mapping.cpp:156,2071); "
        f"accepted loops on config 2 have ICP fitness median "
        f"{r2.get('loop_fitness_accepted_med')} / max {r2.get('loop_fitness_accepted_max')}.",
        "",
        "Config 3: a 70 m corridor with sparse alcoves, driven down and back with a "
        "180-deg in-place turn; config 3l1 runs it under mapping_loss=\"l1\" "
        "(eval.py's notes give the reasons).",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--only", type=str, default=None,
        help="comma-separated config gates to rerun (1, 1p, 2, 3, 3l1, 4, 5_fleet, "
             "5b — or a full result key); the other configs are loaded from the "
             f"existing {RESULTS}",
    )
    ap.add_argument("--out-dir", default=".", help=f"where {RESULTS} and {REPORT} go")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    only = set(args.only.split(",")) if args.only else None
    known_keys = {k for keys in GATES.values() for k in keys}
    if only:
        unknown = only - set(GATES) - known_keys
        if unknown:
            ap.error(f"--only: unknown config gate(s) {sorted(unknown)}; "
                     f"valid gates: {sorted(GATES)}")

    def want(gate: str) -> bool:
        return only is None or gate in only or any(k in only for k in GATES[gate])

    def note(msg: str) -> None:
        print(f"[eval {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)

    line = common.device_line(dev)
    note(f"device: {line}")
    os.makedirs(args.out_dir, exist_ok=True)
    results_path = os.path.join(args.out_dir, RESULTS)
    results = {}
    if only and os.path.exists(results_path):
        with open(results_path) as f:
            results = {k: v for k, v in json.load(f).items() if k in known_keys}

    seqs = {}
    for gate in GATES:
        if not want(gate):
            continue
        shared = {"1p": "1", "3l1": "3"}.get(gate, gate)    # 1/1p and 3/3l1 share a sequence
        if shared not in seqs:
            note(f"config {gate}: generating its sequence")
            seqs = {shared: sequence(shared, args.quick)}
        note(f"config {gate}")
        common.reset_knn()
        for key, r in run_gate(gate, args.quick, dev, seqs[shared]).items():
            results[key] = {**r, "device": line, "quick": args.quick,
                            "knn_launches": common.knn_launches()}
            note(f"{key}: {json.dumps(results[key])}")
        with open(results_path, "w") as f:        # after every gate: a cut run keeps its gates
            json.dump(results, f, indent=2)

    auto = report(results, line)
    # keep manually maintained sections below the marker (eval.py:468-476)
    marker = "<!-- manual sections below -->"
    report_path = os.path.join(args.out_dir, REPORT)
    tail = ""
    if os.path.exists(report_path):
        with open(report_path) as f:
            old = f.read()
        if marker in old:
            tail = old[old.index(marker):]
    with open(report_path, "w") as f:
        f.write(auto + ("\n" + tail if tail else ""))
    note(f"wrote {results_path} and {report_path}")
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
