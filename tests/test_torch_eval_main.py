"""``rgc_slam_tpu_torch.tools.eval.main`` with ``--device cpu``.

At TEST_CONFIG over a few 120-azimuth scans (each gate's switches kept:
loops, IMU covariance mode, mapping loss, lidar-only, inline compaction),
with config 5's fleet cut to 2 robots and 5b to 2 courses: the results
file holds the gates run, each with its device and kNN launches, the
report its table, and an ``--only`` rerun keeps the other gates and the
report's manual sections.
"""
import dataclasses
import json

import pytest
import torch

from rgc_slam_tpu_torch import config as tcfg
from rgc_slam_tpu_torch.io import synthetic as tsyn
from rgc_slam_tpu_torch.tools import eval as teval

torch.set_num_threads(1)


def _tiny_seq(n=5, seed=5):
    return tsyn.generate_sequence(n_scans=n, n_azimuth=120, seed=seed, extent=18.0, radius=8.0,
                                  noise=0.004, closes_loop=False, speed=2.0)


@pytest.fixture()
def small(monkeypatch):
    """The tools' configurations and sequences cut to TEST_CONFIG and a few
    120-azimuth scans."""
    small = dataclasses.replace(tcfg.TEST_CONFIG, inline_compaction=False)
    gate_config = teval.gate_config

    def cfg(gate):
        c = gate_config(gate)
        return dataclasses.replace(small, **{f: getattr(c, f) for f in (
            "loop_closure_enable", "imu_cov_mode", "mapping_loss", "use_imu", "inline_compaction")})

    monkeypatch.setattr(teval, "gate_config", cfg)
    monkeypatch.setattr(teval, "sequence",
                        lambda gate, quick: [_tiny_seq(4, 40 + s) for s in range(2)]
                        if gate == "5b" else _tiny_seq())
    monkeypatch.setattr(teval, "FLEET_B", 2)
    monkeypatch.setattr(teval, "FLEET_STEPS", 2)
    return small


def test_eval_main_on_cpu(small, tmp_path, capsys):
    assert teval.main(["--quick", "--only", "1,3l1,5_fleet,5b", "--device", "cpu",
                       "--out-dir", str(tmp_path)]) == 0
    results = json.loads((tmp_path / teval.RESULTS).read_text())
    assert set(results) == {"1_full_pipeline_no_loop", "3l1_degraded_corridor_l1", "5_fleet_64",
                            "5b_fleet_full_slam_distinct"}
    assert results["3l1_degraded_corridor_l1"]["mapping_loss"] == "l1"
    assert results["5_fleet_64"]["cross_robot_spread_m"] == 0.0
    assert results["5b_fleet_full_slam_distinct"]["robots"] == 2
    assert all(r["device"] == "cpu" and r["knn_launches"] == {} for r in results.values())
    report = (tmp_path / teval.REPORT).read_text()
    assert "| 1_full_pipeline_no_loop | 4 |" in report and "| 2_full_slam_loop | — |" in report
    # --only reruns one gate and keeps the others from the results file
    (tmp_path / teval.REPORT).write_text(report + "<!-- manual sections below -->\nkept\n")
    assert teval.main(["--quick", "--only", "1", "--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    assert set(json.loads((tmp_path / teval.RESULTS).read_text())) == set(results)
    assert (tmp_path / teval.REPORT).read_text().endswith("kept\n")
