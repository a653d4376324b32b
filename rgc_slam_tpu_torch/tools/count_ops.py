"""Count the operators one stream dispatches per scan, on the CPU.

Drives ``SlamSystem(SlamConfig(loop_closure_enable=False))`` over phase
4's synthetic VLP-16 sequence (``chip_smoke.py``) on the CPU and records
each scan's ``process`` call under ``torch.profiler`` (CPU activity
only).  For each recorded scan it counts the operator calls the
profiler saw: all of them (nested calls included) and the top-level ones
(no enclosing operator; on the card about one kernel launch each, PERF.md
§5).  The counts follow the code path, not the device, so two checkouts
are compared without a card, each with the same file:

    PYTHONPATH=<checkout> python rgc_slam_tpu_torch/tools/count_ops.py [--scans 4]

The package is the one on PYTHONPATH.  The last line is a JSON object: the
counts per scan, their medians, and each operator's top-level calls per
scan (``by_name``), which says where two checkouts differ.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=4, help="scans driven (the first 2 not recorded)")
    args = ap.parse_args()
    torch.set_num_threads(2)

    from rgc_slam_tpu_torch import config
    from rgc_slam_tpu_torch.io import synthetic
    from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu_torch.models.slam import SlamSystem

    cfg = config.SlamConfig(loop_closure_enable=False)
    # chip_smoke.py's phase-4 sequence (16 x 1800 points a sweep)
    seq = synthetic.generate_sequence(
        n_scans=args.scans + 1, n_azimuth=1800, seed=5, extent=18.0, radius=8.0, noise=0.004,
        motion_distortion=True, closes_loop=False, speed=2.0)
    system = SlamSystem(cfg, device="cpu")
    per_scan, by_name = [], collections.Counter()
    for k in range(args.scans):
        t_imu, acc, gyr = seq["imu"][k]
        cloud = cloud_from_scan_dict(seq["scans"][k], cfg, "cpu")
        imu = imu_from_interval(t_imu, acc, gyr, cfg.max_imu, "cpu")
        if k < 2:
            system.process(cloud, imu, seq["stamps"][k])
            continue
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            system.process(cloud, imu, seq["stamps"][k])
        events = prof.events()
        top = [e for e in events if e.cpu_parent is None]
        per_scan.append({"scan": k, "all": len(events), "top_level": len(top)})
        by_name.update(e.name for e in top)
    n = len(per_scan)
    record = {
        "scans_recorded": n, "per_scan": per_scan,
        "median_all": statistics.median(s["all"] for s in per_scan),
        "median_top_level": statistics.median(s["top_level"] for s in per_scan),
        "by_name": {name: c / n for name, c in by_name.most_common()},
    }
    print("operator calls per scan, all / top-level: "
          + ", ".join(f"scan {s['scan']} {s['all']} / {s['top_level']}" for s in per_scan))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
