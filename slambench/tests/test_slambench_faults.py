"""A whole run of the cell at a CPU size, the chip's look skipped: sound,
it comes out correct; with the timed path broken underneath, not.

The faults this cell can have: a step that returns its state unchanged, and
an answer altered where it is produced (the map pose).  It has a batch of
one and exchanges nothing between chips.  Beside them, a fault inside the
step's own algorithm, which a judge copied from the program would share: the
mapping's Levenberg-Marquardt solve cut to one iteration.  A log too short
for the window fails the run instead of ending the window early.
"""
import io

import pytest

from rgc_slam_tpu_torch.models import slam as slam_mod
from rgc_slam_tpu_torch.ops import factors as factors_mod
from slambench import run
from slambench.drivers import LogExhausted
from slambench.tests import tiny

CELL = "vlp16_single.open_drive"


def _run(seconds=8.0, traffic=None, **spec_changes):
    # a log of 40 scans outlasts 8 s of calls however fast a fault makes them
    return run.run_cell(tiny.bench(), CELL, tiny.SEED, seconds, False, "cpu",
                        spec_override=lambda s: tiny.spec(s, **spec_changes),
                        traffic_override=lambda t: tiny.traffic(t, **{"log_scans": 40,
                                                                      **(traffic or {})}),
                        soak_s=0.0, out=io.StringIO(), err=io.StringIO())


def _over(res, number):
    c = res["checks"][number]
    return c["value"] > c["limit"]


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 3 and res["failed"] == 0


def test_state_left_unchanged(monkeypatch):
    step = slam_mod.slam_step

    def stuck(state, cloud, imu, stamp, cfg):
        return state, step(state, cloud, imu, stamp, cfg)[1]

    monkeypatch.setattr(slam_mod, "slam_step", stuck)
    res = _run()
    assert not res["correct"]
    assert _over(res, "keyframe_mismatch")


def test_answer_altered_where_produced(monkeypatch):
    step = slam_mod.slam_step

    def off(state, cloud, imu, stamp, cfg):
        state, out = step(state, cloud, imu, stamp, cfg)
        return state, out._replace(t_map=out.t_map + 0.05)

    monkeypatch.setattr(slam_mod, "slam_step", off)
    res = _run()
    assert not res["correct"]
    assert _over(res, "map_pos_med_m")


def test_mapping_solve_cut_short(monkeypatch):
    lm = factors_mod.ceres_lm

    def one_step(residual_fn, cost_fn, dim, *args, **kwargs):
        if dim == 12:                                  # the mapping's, not the fusion's
            kwargs["iterations"] = 1
        return lm(residual_fn, cost_fn, dim, *args, **kwargs)

    monkeypatch.setattr(factors_mod, "ceres_lm", one_step)
    res = _run()
    assert not res["correct"]
    assert _over(res, "map_pos_med_m")


def test_log_exhausted_fails_the_run():
    with pytest.raises(LogExhausted, match="log_scans"):
        _run(seconds=600, traffic={"log_scans": 3}, enable_loop=False)
