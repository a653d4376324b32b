"""Run chip_smoke.py's phase 4 from a given checkout and print the digest of
its poses, so that two checkouts can be held to the same trajectory bit for
bit on the card.

    python rgc_slam_tpu_torch/tools/phase4_digest.py [--checkout DIR]

``DIR`` (default: the checkout holding this file) goes first on the
import path: its ``chip_smoke`` and its ``rgc_slam_tpu_torch`` are the ones
imported, and its kNN kernel is built from its own source.  Phase 4 is
``chip_smoke.main_path_phase``: ``SlamSystem.process`` over the 10-scan
VLP-16 sequence at ``SlamConfig(loop_closure_enable=False)`` on cuda:0.
The digest is the first 16 hex digits of the sha256 of the map-frame
positions as float32 [scans, 3] (``chip_smoke.t_map_digest``).  Since card
runs repeat bit for bit, two checkouts whose arithmetic on this path is the
same print the same digest.  Needs CUDA.  The last line is a JSON object:
the checkout, the digest, the ATE and the median ms/scan.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkout", default=HERE, help="the checkout to run")
    a = p.parse_args()
    root = os.path.abspath(a.checkout)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    smi = chip_smoke.device_phase(torch)
    import rgc_slam_tpu_torch
    from rgc_slam_tpu_torch.ops.cuda import knn as knn_cuda

    for mod in (chip_smoke, rgc_slam_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} was imported from {mod.__file__}, not {root}")
    print(f"built {knn_cuda.build()}")
    run = chip_smoke.main_path_phase(torch, knn_cuda, smi, torch.device("cuda:0"))
    digest = hashlib.sha256(np.ascontiguousarray(run["t_map"], np.float32).tobytes()).hexdigest()
    print(json.dumps({"checkout": root, "digest": digest[:16], "ate_m": run["ate_m"],
                      "median_ms": run["median_ms"], "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
