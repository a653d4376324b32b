"""What the VLP-16 cell reads, pinned, and a whole run of a tiny 64-ring
cell, both from one process of ``slambench/tests/sensor_runs.py`` at one CPU
thread (no JAX there: ``run.run_cell`` refuses to print a result if it finds
JAX loaded).

The pins were computed on the tree before the harness took a second sensor:
the tiny ``open_drive`` log's digest over every entry the driver hands over,
the masked ones too, and the float64 reference's ground plane and map pose
on two sampled calls.  They hold the VLP-16 cell's inputs and its
``correct`` to what they were, bit for bit on this CPU; other float kernels
(another instruction set) may read other last bits.

    python3 -m pytest -q slambench/tests/test_slambench_sensor_runs.py   # ~1 min
"""
import json
import math
import os
import subprocess
import sys

import pytest

from slambench.tests.tiny import ROOT

DIGEST = "0025dbbee6567fc76aec0f91696cc4fd"
REFERENCE = {
    "12": {"ground": [True, -6.802979213554052e-05, -0.0007870890184424779,
                      -0.9999996879313635, 0.5591045419678636],
           "q": [0.0027584111123268953, -0.00020048713288780203, 0.03949593518672332,
                 0.9992159036348307],
           "t": [0.8103319026269848, 0.04844485510501913, 0.004345820678575618],
           "row": {"ground_angle_rad": 1.4197701749550686e-08,
                   "ground_dist_m": 7.944250624003502e-08, "map_pos_m": 2.7644253419722986e-07,
                   "map_rot_rad": 1.108130472206011e-08, "keyframe_mismatch": 0.0}},
    "14": {"ground": [True, -7.548718555965762e-05, -0.000778503931078962,
                      -0.9999996941166103, 0.5592556515020091],
           "q": [0.0027161634415441183, -0.0005968432732838415, 0.04604972965303223,
                 0.998935277499573],
           "t": [1.0884820675848703, 0.06715801096853805, 0.004619133906240903],
           "row": {"ground_angle_rad": 8.202814162948333e-09,
                   "ground_dist_m": 5.1526423128223087e-08, "map_pos_m": 1.931191702109203e-07,
                   "map_rot_rad": 1.2244724868165216e-08, "keyframe_mismatch": 0.0}},
}


@pytest.fixture(scope="module")
def runs():
    out = subprocess.run([sys.executable, "-m", "slambench.tests.sensor_runs"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_vlp16_log_is_pinned(runs):
    assert runs["pin"]["digest"] == DIGEST


@pytest.mark.parametrize("call", sorted(REFERENCE))
def test_vlp16_reference_is_pinned(runs, call):
    got, want = runs["pin"]["calls"][call], REFERENCE[call]
    assert got["optimized"]
    assert got["ground"] == want["ground"]
    assert got["q"] == want["q"] and got["t"] == want["t"]
    assert {k: got["row"][k] for k in want["row"]} == want["row"]


def test_tiny_64_ring_cell_reaches_its_result(runs):
    k = runs["kitti"]
    res = k["result"]
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    # the first call and one window call or more (a busy CPU makes few calls in the window)
    assert res["attempted"] >= 2 and len(k["samples"]) == res["attempted"]
    for name in ("map_pos_med_m", "map_rot_med_rad"):
        assert math.isfinite(res["checks"][name]["value"])
    for name in ("map_pos_max_m", "map_rot_max_rad"):
        assert math.isfinite(k["diagnostic"][name])
    assert k["diagnostic"]["ground_dist_max_m"] is None
    assert k["diagnostic"]["ground_angle_max_rad"] is None
    assert all(s["ground_dist_m"] is None for s in k["samples"])
    assert {"scans_per_s", "scan_ms_p95", "setup_s"} <= set(res["metrics"])
