"""How far a last-bit change moves the evaluation harness's sequence, on the
CPU: ``tools.eval.run_sequence`` on the drive of
``test_torch_eval.py::test_run_sequence_matches_eval_py`` (13 scans, 240
azimuth, TEST_CONFIG with 32 keyframes, a loop step every 10 scans) at
several seeds, beside the JAX harness (``eval.py``'s ``run_sequence``) on
the same scans and on the scans with every coordinate scaled by
1 + 1e-7 N(0, 1) (``--perturb`` seeds): the reference's own spread under a
last-bit change of its input.

    python tests/torch_ground_drift.py [--seeds 5 6 7] [--threads 1 2 4] [--perturb 3]

The port runs with the ground fit's 3x3 solved by

* ``lapack``: ``utils.math3d.eigh_or_nan``, the CPU's solver, at each torch
  thread count of ``--threads`` (the thread count changes only how torch's
  CPU reductions split their sums);
* ``closed-f32``: ``ops.covariance.eigh3x3``, the card's solver, in float32;
* ``closed-f64``: the same closed form in float64, rounded to float32;

the closed forms at the first thread count.  One JSON line a run (ATE of
the map and odometry trajectories and the map RPE, metres, as
``run_sequence`` rounds them), then a table; the test's gate on each is
|port - JAX| <= 0.05 x JAX + 0.01 m.
"""
import argparse
import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch_eval_roots  # noqa: E402
from rgc_slam_tpu import config as jcfg  # noqa: E402
from rgc_slam_tpu_torch import config as tcfg  # noqa: E402
from rgc_slam_tpu_torch.io import synthetic as tsyn  # noqa: E402
from rgc_slam_tpu_torch.ops import covariance, features  # noqa: E402
from rgc_slam_tpu_torch.tools import eval as teval  # noqa: E402
from rgc_slam_tpu_torch.utils import math3d as m3  # noqa: E402

KEYS = ("ate_map_m", "ate_odom_m", "rpe_map_m")
SOLVERS = {
    "lapack": m3.eigh_or_nan,
    "closed-f32": covariance.eigh3x3,
    "closed-f64": lambda cov: tuple(x.to(cov.dtype) for x in covariance.eigh3x3(cov.double())),
}


def sequence(seed: int) -> dict:
    return tsyn.generate_sequence(n_scans=13, n_azimuth=240, seed=seed, extent=18.0, radius=8.0,
                                  noise=0.004, closes_loop=False, speed=2.0)


def perturbed(seq: dict, seed: int) -> dict:
    """``seq`` with every scan's coordinates scaled by 1 + 1e-7 N(0, 1)."""
    g = np.random.default_rng(seed)
    scans = [dict(s, xyz=(s["xyz"] * (1 + 1e-7 * g.standard_normal(s["xyz"].shape)))
                  .astype(np.float32)) for s in seq["scans"]]
    return dict(seq, scans=scans)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[5, 6, 7])
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--perturb", type=int, default=3)
    args = ap.parse_args(argv)
    cfg_t = dataclasses.replace(tcfg.TEST_CONFIG, max_keyframes=32)
    cfg_j = jcfg.SlamConfig(**{f.name: getattr(cfg_t, f.name)
                               for f in dataclasses.fields(cfg_t)})
    jeval = torch_eval_roots.load("eval")
    runs = [("lapack", n) for n in args.threads] + [(s, args.threads[0]) for s in SOLVERS
                                                    if s != "lapack"]
    rows = []
    for seed in args.seeds:
        seq = sequence(seed)
        ref = jeval.run_sequence(cfg_j, seq, loop_every=10)
        row = {"seed": seed, "jax": {k: ref[k] for k in KEYS}, "jax_perturbed": []}
        for p in range(1, args.perturb + 1):
            pert = jeval.run_sequence(cfg_j, perturbed(seq, p), loop_every=10)
            row["jax_perturbed"].append({k: pert[k] for k in KEYS})
        print(json.dumps(row), flush=True)
        for solver, threads in runs:
            torch.set_num_threads(threads)
            features._ground_eigh = SOLVERS[solver]
            port = teval.run_sequence(cfg_t, seq, loop_every=10, device="cpu")
            r = {"seed": seed, "solver": solver, "threads": threads,
                 **{k: port[k] for k in KEYS},
                 "within_gate": all(abs(port[k] - ref[k]) <= 0.05 * ref[k] + 0.01 for k in KEYS)}
            print(json.dumps(r), flush=True)
            row[f"{solver}/{threads}"] = r
        rows.append(row)
    print("| seed | run | ATE map | ATE odom | RPE map | within the test's gate |")
    print("|---|---|---|---|---|---|")
    for row in rows:
        print(f"| {row['seed']} | JAX | " + " | ".join(str(row["jax"][k]) for k in KEYS) + " | |")
        for p, r in enumerate(row["jax_perturbed"], 1):
            print(f"| {row['seed']} | JAX, perturbed (seed {p}) | "
                  + " | ".join(str(r[k]) for k in KEYS) + " | |")
        for solver, threads in runs:
            r = row[f"{solver}/{threads}"]
            print(f"| {row['seed']} | {solver}, {threads} thread(s) | "
                  + " | ".join(str(r[k]) for k in KEYS) + f" | {r['within_gate']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
