"""sp-axis scaling of one robot's step: the port of ``eval_sp.py``.

    python -m rgc_slam_tpu_torch.tools.eval_sp --sp S [--out-dir DIR] [--device cuda|cpu]
    python -m rgc_slam_tpu_torch.tools.eval_sp --table [--out-dir DIR]

Runs one robot over a ("dp"=1, "sp"=S) mesh of S gloo ranks
(``parallel.distributed.run_ranks`` / ``make_mesh``, ``run_mesh``) through
``fleet.make_distributed_step`` at ``CFG`` (``eval_sp.py:41-53``), and
reports the per-step latency (median of N_REPS windows of N_TIMED steps
after N_WARM) and the final pose, whose drift from S=1 is the correctness
column.  S in {1, 2, 4, 8} with ``--device cpu``; S in {1, 2} ranks share
cuda:0 (NCCL refuses two ranks on one GPU, so the ranks use gloo, which
stages each all-reduce through the host): neither is a scaling number of
separate devices.  One size per call; rows accumulate in
``eval_sp_torch.json`` under ``--out-dir`` (never ``eval_sp.json``), and
``--table`` (or a call without ``--sp``) prints the table.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ..config import SlamConfig
from ..io import synthetic
from ..io.convert import cloud_from_scan_dict, imu_from_interval
from ..types import tree_items
from . import common

# mid-size caps: big enough that association/registration dominate
CFG = SlamConfig(
    max_points=16384,
    max_source_points=4096,
    max_voxels=8192,
    max_keyframes=128,
    max_kf_corner=256,
    max_kf_surf=1024,
    max_map_points=8192,
    max_loop_submap_points=4096,
    loop_closure_enable=False,
    inline_compaction=False,
)

N_WARM, N_TIMED, N_REPS = 3, 10, 3
RESULTS = "eval_sp_torch.json"


def stage_inputs(cfg: SlamConfig, n: int):
    """The first ``n`` scans as numpy (cloud fields, imu fields, stamp): the
    ranks receive them pickled and put them on their device."""
    seq = synthetic.generate_sequence(
        n_scans=n + 1, n_azimuth=900, seed=3, extent=30.0, radius=12.0,
        noise=0.01, closes_loop=False, speed=2.0,
    )
    out = []
    for k in range(n):
        t_imu, acc, gyr = seq["imu"][k]
        out.append((
            {name: v.numpy() for name, v in tree_items(cloud_from_scan_dict(seq["scans"][k], cfg,
                                                                            "cpu"))},
            {name: v.numpy() for name, v in tree_items(imu_from_interval(t_imu, acc, gyr,
                                                                         cfg.max_imu, "cpu"))},
            float(seq["stamps"][k])))
    return out


def _mesh_rank(rank, world, device, inputs, cfg, counts):
    """One rank of ``run_mesh``: (ms per step, the robot's last t_map)."""
    from ..parallel import fleet
    from ..types import ImuBatch, PointCloud

    n_warm, n_timed, n_reps = counts
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)     # every rank on the same card
        torch.cuda.set_device(device)
    mesh = fleet.make_mesh(1, world, device)
    step = fleet.make_distributed_step(mesh, cfg)
    states = fleet.fleet_init(cfg, 1, device)

    def lane(cls, arrays):
        return cls(**{k: torch.from_numpy(v).to(device)[None] for k, v in arrays.items()})

    batches = [(lane(PointCloud, c), lane(ImuBatch, i),
                torch.tensor([s], dtype=torch.float32, device=device)) for c, i, s in inputs]
    for k in range(n_warm):
        states, outs, _ = step(states, *batches[k])
    common.sync(device)
    times = []
    for _ in range(n_reps):
        s = states
        t0 = time.perf_counter()
        for k in range(n_warm, n_warm + n_timed):
            s, outs, _ = step(s, *batches[k])
        common.sync(device)
        times.append((time.perf_counter() - t0) / n_timed)
    # advance for the returned trajectory check
    for k in range(n_warm, n_warm + n_timed):
        states, outs, _ = step(states, *batches[k])
    common.sync(device)
    return statistics.median(times) * 1e3, outs.t_map[0].cpu().numpy()


def run_mesh(n_sp: int, inputs, device="cuda", cfg: SlamConfig = CFG,
             counts=(N_WARM, N_TIMED, N_REPS), timeout_s: float = 3000):
    """(ms per step, last t_map) of one robot on a (1, n_sp) mesh of gloo
    ranks, ``counts`` = (warm-up, timed, repetitions) steps over ``inputs``
    (at least warm-up + timed scans); every rank returns the same pose,
    checked here."""
    from ..parallel.distributed import run_ranks

    dev = torch.device(device)
    if dev.type == "cuda":
        from ..ops.cuda import knn as knn_cuda
        knn_cuda.build()           # once here: the ranks load it
    outs = run_ranks(_mesh_rank, n_sp, dev, (inputs, cfg, counts), timeout_s=timeout_s)
    for ms, t_map in outs[1:]:
        assert np.array_equal(t_map, outs[0][1]), "the ranks' poses differ"
    return max(ms for ms, _ in outs), outs[0][1]


def table(rows) -> str:
    base = next((r for r in rows if r["sp"] == 1), None)
    lines = ["| sp | ms/step | speedup | t_map drift (m) | device |", "|---|---|---|---|---|"]
    for r in rows:
        speed = round(base["ms_per_step"] / r["ms_per_step"], 3) if base else None
        drift = (float(np.abs(np.asarray(r["t_map"]) - np.asarray(base["t_map"])).max())
                 if base else 0.0)
        lines.append(f"| {r['sp']} | {r['ms_per_step']} | {speed} | {drift:.2e} | {r['device']} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sp", type=int, default=0, help="run one mesh size")
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--out-dir", default=".", help=f"where {RESULTS} goes")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    path = os.path.join(args.out_dir, RESULTS)
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = json.load(f)

    if args.sp:
        dev = common.device(args.device)
        inputs = stage_inputs(CFG, N_WARM + N_TIMED)
        ms, t_map = run_mesh(args.sp, inputs, dev, CFG, (N_WARM, N_TIMED, N_REPS))
        rows = [r for r in rows if r["sp"] != args.sp]
        rows.append({"sp": args.sp, "ms_per_step": round(ms, 2),
                     "t_map": [round(float(v), 6) for v in t_map],
                     "device": common.device_line(dev)})
        rows.sort(key=lambda r: r["sp"])
        os.makedirs(args.out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(rows, f, indent=2)

    if args.table or not args.sp:
        print(table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
