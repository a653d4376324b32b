"""The control: the reference computed in TF32 (float32 with every operand
of its matrix products and solves rounded to TF32, the precision below the
configuration's float32 with TF32 off), put in the program's place, fails
the cell's limits, while the program passes them.  At the cell's own size
on the card this is ``python3 -m slambench.calibrate``; here a size a test
run holds.  TF32 is emulated bit for bit, so the control reads alike on the
CPU and on the card.

    python3 -m pytest -q slambench/tests/test_slambench_control.py
"""
import json
import os

from slambench import calibrate
from slambench.tests import tiny

CELL = "vlp16_single.open_drive"


def test_control_fails_the_limits():
    with open(os.path.join(tiny.ROOT, "slambench", "limits", CELL + ".json")) as f:
        limits = json.load(f)
    r = calibrate.readings(tiny.bench(), CELL, tiny.SEED, 8.0, "cpu", spec_override=tiny.spec,
                           traffic_override=lambda t: tiny.traffic(t, log_scans=40))
    assert len(r["sampled"]) >= 4
    assert all(r["program"][k] <= limits[k] for k in limits), r
    assert all(r["witness"][k] <= limits[k] for k in limits), r
    assert any(r["control"][k] > limits[k] for k in limits), r
