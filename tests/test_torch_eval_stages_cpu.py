"""``rgc_slam_tpu_torch.tools.eval_stages`` with ``--device cpu``: ``main``
(the single-stream rows), ``fleet_differential`` and ``fleet_breakdown`` at
TEST_CONFIG, with finite wall times and no device column off the card."""
import dataclasses

import pytest
import torch

from rgc_slam_tpu_torch import config as tcfg
from rgc_slam_tpu_torch.tools import eval_stages

torch.set_num_threads(1)
SMALL = dataclasses.replace(tcfg.TEST_CONFIG, inline_compaction=False)


@pytest.fixture()
def small(monkeypatch):
    monkeypatch.setattr(eval_stages, "BENCH_CONFIG", SMALL)
    monkeypatch.setattr(eval_stages, "FLEET_CONFIG", SMALL)
    return SMALL


def test_eval_stages_on_cpu(small, capsys):
    assert eval_stages.main(["--reps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "no FLOP column" in out and "mapping≈" in out
    rows = eval_stages.fleet_differential(2, 1, torch.device("cpu"))
    assert rows["full"]["wall_ms"] > 0 and rows["feat"]["device_ms"] is None
    assert set(eval_stages.fleet_breakdown(2, 1, torch.device("cpu"))) == {
        "features", "feat+odo", "full"}
