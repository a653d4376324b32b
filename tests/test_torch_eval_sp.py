"""``rgc_slam_tpu_torch.tools.eval_sp.main`` with ``--device cpu``: a
(1, 2) mesh of gloo ranks on the CPU."""
import dataclasses
import json

import torch

from rgc_slam_tpu_torch import config as tcfg
from rgc_slam_tpu_torch.tools import eval_sp

torch.set_num_threads(1)


def test_eval_sp_main_on_cpu(monkeypatch, tmp_path, capsys):
    """Two gloo ranks on the CPU, TEST_CONFIG cut for sp=2, one warm-up and
    one timed step: the ranks agree (run_mesh checks it), the row lands in
    eval_sp_torch.json and the table reads it."""
    monkeypatch.setattr(eval_sp, "CFG", dataclasses.replace(
        tcfg.TEST_CONFIG, loop_closure_enable=False, inline_compaction=False))
    for name in ("N_WARM", "N_TIMED", "N_REPS"):
        monkeypatch.setattr(eval_sp, name, 1)
    assert eval_sp.main(["--sp", "2", "--table", "--device", "cpu", "--out-dir", str(tmp_path)]) == 0
    rows = json.loads((tmp_path / eval_sp.RESULTS).read_text())
    assert [r["sp"] for r in rows] == [2] and rows[0]["device"] == "cpu"
    assert "| 2 |" in capsys.readouterr().out
