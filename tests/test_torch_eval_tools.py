"""The evaluation programs of ``rgc_slam_tpu_torch.tools`` on the CPU.

* ``eval_pgo.make_graph`` equals ``eval_pgo.py``'s graph bit for bit (the
  drifted keyframe positions and travel, the loop constraint, the ground
  truth; the keyframe quaternions, from float32 sin / cos, to one ulp of 1),
  and
  ``run_case``'s post-PGO keyframe ATE at K=64 is within 1e-4 m of the JAX
  package's ``_pgo_solve`` on the same graph.
* ``eval_pgo``, ``eval_sp_feature_probe`` and ``eval_longrun_fleet`` run
  with ``--device cpu`` (``main``, at a small size where the full one
  would take minutes on the CPU; the other tools: the other
  tests/test_torch_eval_*.py files),
  and every tool raises, with no CPU fallback, when it is asked for CUDA
  on a machine without it.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from rgc_slam_tpu.config import SlamConfig as JConfig
from rgc_slam_tpu.models.loop import _pgo_solve as j_pgo_solve
from rgc_slam_tpu_torch import config as tcfg
from rgc_slam_tpu_torch.tools import (eval as teval, eval_longrun, eval_longrun_fleet, eval_pgo,
                                      eval_sp, eval_sp_feature_probe, eval_stages)

import torch_eval_roots

torch.set_num_threads(1)
K = 64


def _cfg(K):
    return dict(max_keyframes=K, max_kf_corner=8, max_kf_surf=8, max_loops=8, pgo_cg_iters=128)


def test_make_graph_matches_eval_pgo_py():
    jpgo = torch_eval_roots.load("eval_pgo")
    ms_t, ls_t, gt_t = eval_pgo.make_graph(tcfg.SlamConfig(**_cfg(K)), K, device="cpu")
    ms_j, ls_j, gt_j = jpgo.make_graph(JConfig(**_cfg(K)), K)
    assert np.array_equal(gt_t, gt_j)
    for name in ("kf_t", "kf_travel", "kf_count"):
        assert np.array_equal(getattr(ms_t, name).numpy(), np.asarray(getattr(ms_j, name))), name
    # the unit quaternions come from float32 sin / cos, whose last bit XLA's
    # CPU library and torch's round apart: one float32 ulp of 1, no more
    q_t, q_j = ms_t.kf_q.numpy(), np.asarray(ms_j.kf_q)
    assert np.abs(q_t - q_j).max() <= np.spacing(np.float32(1.0))
    for name in ("loop_i", "loop_j", "loop_t", "loop_yaw", "loop_count"):
        assert np.array_equal(getattr(ls_t, name).numpy(), np.asarray(getattr(ls_j, name))), name


def test_run_case_matches_eval_pgo_py():
    jpgo = torch_eval_roots.load("eval_pgo")
    cfg = JConfig(**_cfg(K))
    ms, ls, gt = jpgo.make_graph(cfg, K)
    ref = jpgo.ate(jax.jit(functools.partial(j_pgo_solve, cfg=cfg))(ms, ls).kf_t, gt, K)
    port = eval_pgo.run_case(K, 128, reps=1, device="cpu")
    assert port["ate_after_m_unrounded"] < port["ate_before_m_unrounded"]
    assert abs(port["ate_after_m_unrounded"] - ref) <= 1e-4, (port, ref)
    assert port["ate_before_m_unrounded"] == jpgo.ate(ms.kf_t, gt, K)


def test_eval_pgo_and_probe_on_cpu(monkeypatch, capsys):
    run_case = eval_pgo.run_case
    monkeypatch.setattr(eval_pgo, "run_case",
                        lambda K, cg, device: run_case(K // 8, cg, reps=1, device=device))
    assert eval_pgo.main(["--device", "cpu"]) == 0
    assert "| 64 | 128 |" in capsys.readouterr().out
    time_features = eval_sp_feature_probe.time_features
    monkeypatch.setattr(eval_sp_feature_probe, "time_features",
                        lambda cfg, rings, az, seed, device: time_features(
                            eval_sp_feature_probe.probe_config(rings, 128, 1), rings, 128, seed,
                            device, n=1))
    assert eval_sp_feature_probe.main(["--device", "cpu"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["device"] == "cpu" and record["verdict"].startswith("sp-halo")


def test_longrun_fleet_main_on_cpu(monkeypatch, capsys):
    for name, value in (("B", 2), ("N_SCANS", 9), ("N_SEEDS", 2),
                        ("CFG", eval_longrun_fleet.fleet_config(24))):
        monkeypatch.setattr(eval_longrun_fleet, name, value)
    with pytest.raises(AssertionError, match="never compacted"):   # 8 scans: no compaction
        eval_longrun_fleet.main(["--device", "cpu"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["robots"] == 2 and record["n_scans"] == 8 and not record["nan_found"]


@pytest.mark.parametrize("tool, argv", [
    (teval, ["--quick"]), (eval_stages, []), (eval_pgo, []), (eval_longrun, ["--scans", "3"]),
    (eval_longrun_fleet, []), (eval_sp_feature_probe, []), (eval_sp, ["--sp", "1"]),
])
def test_tools_raise_without_cuda(tool, argv, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv + ["--out-dir", str(tmp_path)] if tool in (teval, eval_sp) else argv)
