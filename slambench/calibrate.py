"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 -m slambench.calibrate --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed, in one process: the cell's set-up, a window of ``--seconds``
(the same calls and seeded sample as a run, with no soak), then the numbers
of the program against the float64 reference, and of two stand-ins put in
the program's place: the reference in float32 (``witness``: an honest
float32 program that sums in another order) and the control, the reference
in TF32 (the precision below the configuration's float32 with TF32 off),
on the first ``--stand-ins`` seeds.  One JSON line a seed on standard
output: the numbers over the sampled calls, and each sampled call's.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys


def readings(bench, workload: str, seed: int, seconds: float, device, stand_ins: bool = True,
             spec_override=None, traffic_override=None) -> dict:
    import torch

    from slambench import run
    from slambench.record import Spans
    from slambench.reference import compare

    _, spec, traffic, _ = run.cell(bench, workload)
    spec = spec_override(spec) if spec_override else spec
    traffic = traffic_override(traffic) if traffic_override else traffic
    dev = torch.device(device)
    spans = Spans()
    driver_mod = importlib.import_module("slambench.drivers." + spec["driver"])
    driver = driver_mod.Driver(spec, traffic, seed, dev, spans, {})
    driver.sample(seed)
    calls, _ = run.window(driver, spans, seconds)
    driver.stop_sampling()
    driver.release()
    gc.collect()
    cfg = driver.ref_cfg
    rows = {"program": [], "witness": [], "control": []}
    for call in driver.calls():
        ref = compare.reference(call, cfg, "float64")
        rows["program"].append(compare.row(call, ref, cfg))
        for name, prec in (("witness", "float32"), ("control", "tf32"))[:2 if stand_ins else 0]:
            rows[name].append(compare.stand_in_row(call, compare.reference(call, cfg, prec), ref,
                                                   cfg))
    keys = ("map_pos_m", "map_rot_rad", "keyframe_mismatch", "ground_dist_m", "ground_angle_rad")
    return {"seed": seed, "calls": len(calls), "sampled": [r["i"] for r in rows["program"]],
            **{k: compare.summary(v) for k, v in rows.items() if v},
            "rows": {k: [[r[n] for n in keys] for r in v] for k, v in rows.items() if v}}


def main(argv=None) -> int:
    from slambench import run

    ap = argparse.ArgumentParser(description="readings for the limits of correct")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--stand-ins", type=int, default=3,
                    help="seeds, from the first, that also read the witness and the control")
    args = ap.parse_args(argv)
    for var, sub in run.CACHES.items():
        os.environ[var] = os.path.join(run.ROOT, "slambench", "_cache", sub)
    bench = run.load_json("BENCHMARK.json")
    for n, seed in enumerate(int(x) for x in args.seeds.split(",")):
        print(json.dumps(readings(bench, args.workload, seed, args.seconds, "cuda:0",
                                  stand_ins=n < args.stand_ins)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
