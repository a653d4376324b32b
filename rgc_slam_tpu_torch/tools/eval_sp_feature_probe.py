"""Does the feature stage leave the dispatch floor on a single dense stream?
The port of ``eval_sp_feature_probe.py``.

    python -m rgc_slam_tpu_torch.tools.eval_sp_feature_probe [--device cuda|cpu]

Times ``ops.features.extract_features`` on one stream at 131072-point caps
(64 rings x 2048 azimuth, 10x the sharp/flat/intensity budgets:
``probe_config``, ``eval_sp_feature_probe.py:73-84``), the same stage at
the product 16-ring cap, and the dispatch floor: one trivial synchronized
op on the same input (``c.xyz[0] + 1.0``), all as median synchronized wall
ms of 30 calls (``time_features``, ``:86-102``).  The decision rule is the
original's: if the dense feature time stays within 2x the floor, the
halo-exchange sp design for the feature stage stays closed; otherwise it
has its first real justification.  XLA's FLOP count has no PyTorch
counterpart: ``dense_feature_gflops`` is null.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..config import SlamConfig
from ..io import synthetic
from ..io.convert import cloud_from_scan_dict
from ..ops import features as F
from . import common


def _note(msg):
    print(f"[probe {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _median_ms(fn, args, dev, n=30):
    fn(*args)
    common.sync(dev)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        common.sync(dev)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def probe_config(n_rings: int, n_azimuth: int, cap_scale: int) -> SlamConfig:
    return SlamConfig(
        n_scans=n_rings,
        use_ground=False,                     # no ground table at 64 beams
        use_imu=False,
        max_points=n_rings * n_azimuth,
        max_points_per_ring=n_azimuth,
        max_sharp_total=2048 * cap_scale,
        max_flat_total=4096 * cap_scale,
        max_inten_total=2048 * cap_scale,
    )


def time_features(cfg: SlamConfig, n_rings: int, n_azimuth: int, seed: int, device="cuda",
                  n: int = 30):
    """(feature ms, dispatch-floor ms, None, valid points) on one scan."""
    dev = torch.device(device)
    world = synthetic.default_world(seed=seed, extent=40.0)
    rng = np.random.default_rng(seed)
    scan = synthetic.cast_scan(
        world, np.eye(3), np.array([0.0, 0.0, 0.56]), n_rings=n_rings,
        n_azimuth=n_azimuth, rng=rng, noise=0.01,
    )
    cloud = cloud_from_scan_dict(scan, cfg, dev)
    ms = _median_ms(functools.partial(F.extract_features, cfg=cfg), (cloud,), dev, n)
    # dispatch floor: one trivial synchronized op on the same input
    floor_ms = _median_ms(lambda c: c.xyz[0] + 1.0, (cloud,), dev, n)
    return ms, floor_ms, None, int(cloud.mask.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    line = common.device_line(dev)

    _note("dense probe: 64 rings x 2048 az = 131072-point caps, 10x budgets")
    dense_ms, dense_floor, dense_gflops, dense_n = time_features(
        probe_config(64, 2048, 10), 64, 2048, seed=5, device=dev)
    _note(f"dense features {dense_ms:.2f} ms (floor {dense_floor:.2f} ms)")

    _note("product probe: 16 rings x 900 az = 16384-point caps")
    prod_cfg = dataclasses.replace(probe_config(16, 1024, 1), max_points=16384, use_ground=True)
    prod_ms, prod_floor, _, prod_n = time_features(prod_cfg, 16, 900, seed=5, device=dev)
    _note(f"product features {prod_ms:.2f} ms (floor {prod_floor:.2f} ms)")

    floor = min(dense_floor, prod_floor)
    ratio = dense_ms / floor if floor > 0 else None
    verdict = (
        "sp-halo stays closed: the dense feature stage is within ~2x of the "
        "dispatch floor — sharding it would shave compute the floor hides"
        if ratio is not None and ratio < 2.0 else
        "sp-halo revisit justified: the dense feature stage clears the "
        "dispatch floor — a ±5-point halo exchange over sp would now buy "
        "real single-stream latency"
    )
    print(json.dumps({
        "probe": "sp feature-stage revisit (PARITY §sp)",
        "device": line,
        "dense_caps": {"rings": 64, "azimuth": 2048, "max_points": 131072,
                       "valid_points": dense_n},
        "dense_feature_ms": round(dense_ms, 3),
        "dense_dispatch_floor_ms": round(dense_floor, 3),
        "dense_feature_gflops": dense_gflops,
        "product_feature_ms": round(prod_ms, 3),
        "product_valid_points": prod_n,
        "dense_over_floor_x": round(ratio, 2) if ratio else None,
        "verdict": verdict,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
