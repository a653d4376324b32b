"""Runs the sensor tests read, in a process of their own at one CPU thread
(the program's CPU kernels sum in another order at other thread counts):

* ``pin``: the tiny ``vlp16_single.open_drive`` cell's log, digested over
  every entry the driver hands over (masked ones too), and the float64
  reference's stages on two sampled calls of a fixed sequence of calls;
* ``kitti``: a whole run (``run.run_cell``) of a tiny 64-ring cell: an
  HDL-64E without a ring channel on a street grid, no IMU, no ground.

    python3 -m slambench.tests.sensor_runs

prints one JSON line: {"pin": ..., "kitti": ...}.
"""
from __future__ import annotations

import hashlib
import io
import json
import sys
import time

import numpy as np
import torch

from slambench import run
from slambench.drivers import slam_system
from slambench.record import Spans
from slambench.reference import compare
from slambench.tests import tiny

CELL = "vlp16_single.open_drive"
PIN_CALLS = (12, 14)          # the third and fifth calls after the 10 warm-up calls

STREETS = {
    "world": {"kind": "street_grid", "block_m": 40.0, "street_m": 12.0, "margin_m": 45.0,
              "building": {"frontage_m": [8.0, 20.0], "gap_m": [2.0, 8.0],
                           "setback_m": [2.0, 5.0], "depth_m": [8.0, 15.0],
                           "height_m": [4.0, 15.0]},
              "car": {"length_m": [3.8, 4.8], "width_m": [1.7, 1.9], "height_m": [1.4, 1.7],
                      "gap_m": [1.0, 10.0], "kerb_gap_m": 0.2, "corner_clear_m": 8.0},
              "pole": {"spacing_m": [20.0, 30.0], "radius_m": [0.1, 0.2],
                       "height_m": [6.0, 9.0], "kerb_offset_m": 0.5},
              "tree": {"spacing_m": [8.0, 16.0], "radius_m": [0.2, 0.4],
                       "height_m": [4.0, 9.0], "kerb_offset_m": 1.5},
              "albedo": [30.0, 220.0]},
    "trajectory": {"kind": "street_drive", "speed": 8.0, "dt": 0.1, "height": 1.73,
                   "leg_blocks": 1, "turn_radius_m": 6.0},
    "range_noise_m": 0.02, "motion_distortion": True, "log_scans": 40,
}


def kitti_spec(s: dict) -> dict:
    """The tiny 64-ring configuration: io/kitti's overrides at the test
    capacities, 64 x 240 sweeps and 16384 points, as
    tests/test_torch_stress_configs.py sizes its KITTI-style drive."""
    s = tiny.spec(s, enable_loop=False)
    s["sensor"] = {"model": "HDL-64E", "rings": 64, "azimuth": 240, "rate_hz": 10.0,
                   "max_range_m": 40.0, "ring_channel": False}
    s["slam_config"] = {**s["slam_config"], "n_scans": 64, "use_imu": False,
                        "use_ground": False, "max_points": 16384, "lidar_height": 1.73,
                        "minimum_range": 5.0}
    return s


def kitti_traffic(_: dict) -> dict:
    """The street log in place of the cell's traffic: no IMU entry."""
    return dict(STREETS)


def log_digest(driver) -> str:
    """sha256 of every array the driver hands over, the truth with them."""
    h = hashlib.sha256()
    for s in driver.scans:
        for k in sorted(s):
            h.update(k.encode())
            h.update(np.ascontiguousarray(s[k]).tobytes())
    for window in driver.imu:
        for a in window:
            h.update(np.ascontiguousarray(a).tobytes())
    h.update(np.asarray(driver.stamps, np.float64).tobytes())
    h.update(np.asarray(driver.truth, np.float64).tobytes())
    return h.hexdigest()[:32]


def pin() -> dict:
    _, spec, traffic, _ = run.cell(tiny.bench(), CELL)
    driver = slam_system.Driver(tiny.spec(spec), tiny.traffic(traffic), tiny.SEED, "cpu",
                                Spans(), {})
    digest = log_digest(driver)
    driver.sample(tiny.SEED)
    while driver.next <= max(PIN_CALLS):
        driver.step_call()
    driver.stop_sampling()
    driver.release()
    calls = {}
    for call in driver.calls():
        if call["i"] in PIN_CALLS:
            ref = compare.reference(call, driver.ref_cfg, "float64")
            g, m = ref["ground"], ref["mapping"]
            calls[str(call["i"])] = {
                "ground": [bool(g["valid"]), *map(float, g["normal"]), g["distance"]],
                "q": m["q"].tolist(), "t": m["t"].tolist(), "optimized": m["optimized"],
                "row": compare.row(call, ref, driver.ref_cfg)}
    return {"digest": digest, "calls": calls}


def kitti() -> dict:
    err = io.StringIO()
    t0 = time.perf_counter()
    result = run.run_cell(tiny.bench(), CELL, tiny.SEED, 10.0, False, "cpu",
                          spec_override=kitti_spec, traffic_override=kitti_traffic, soak_s=0.0,
                          out=io.StringIO(), err=err)
    lines = err.getvalue().splitlines()
    diag = next(json.loads(x.split(" ", 1)[1]) for x in lines if x.startswith("diagnostic "))
    samples = [json.loads(x.split(" ", 1)[1]) for x in lines if x.startswith("sample ")]
    return {"result": result, "diagnostic": diag, "samples": samples,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    torch.set_num_threads(1)
    print(json.dumps({"pin": pin(), "kitti": kitti()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
