"""The port's CLI in fleet mode (``--fleet B``) against the JAX CLI's, on the CPU.

Both CLIs run two robots over the same 3-scan sweep log in chunks of 2 (one
chunk, then the trailing scan alone), each building TEST_CONFIG's
capacities with ``loop_cadence=2`` and the CLI's overrides (as
tests/test_torch_cli.py does): without loops (``fleet_step_compacting``
under ``make_chunk_step``) and with loops (``make_fleet_chunk_step``).
``fleet_final_poses.txt`` must hold the JAX CLI's within
tests/test_torch_slam.py's early-scan gate (5e-3 m), both robots at one
pose, and the loop step must fire after the same scans as the JAX CLI's,
read there by a callback inside its ``fleet_loop_step``.  The case with
loops is tests/test_torch_cli_fleet_loops.py, a file of its own so that
test workers that take whole files run the two at once.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import rgc_slam_tpu.config as j_config
from rgc_slam_tpu import run as j_run
from rgc_slam_tpu.parallel import fleet as j_fleet
from rgc_slam_tpu_torch import run as t_run
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io import synthetic
from rgc_slam_tpu_torch.parallel import fleet
from rgc_slam_tpu_torch.runtime.loader import write_sequence

torch.set_num_threads(1)
GATE = 5e-3
FLEET = ["--fleet", "2", "--chunk", "2"]


@pytest.fixture(scope="module")
def log(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    seq = synthetic.generate_sequence(n_scans=4, n_azimuth=120, seed=5, extent=18.0, radius=8.0,
                                      noise=0.004, closes_loop=False, speed=2.0)
    write_sequence(str(d / "s.slog"), seq)
    return str(d / "s.slog")


def run_and_check(log, tmp_path, monkeypatch, loops: bool):
    """Both CLIs over ``log`` in fleet mode, held to each other."""
    monkeypatch.setattr(j_config, "SlamConfig",
                        lambda **kw: dataclasses.replace(j_config.TEST_CONFIG, loop_cadence=2, **kw))
    monkeypatch.setattr(t_run, "SlamConfig",
                        lambda **kw: dataclasses.replace(TCFG, loop_cadence=2, **kw))
    j_fired, t_fired = [], []
    j_real, t_real = j_fleet.fleet_loop_step, fleet.fleet_loop_step

    def j_counted(states, loop_states, cfg):
        # runs inside the jitted lax.cond branch, so only when it is taken
        jax.debug.callback(lambda f: j_fired.append(int(f)), states.odo.frame[0])
        return j_real(states, loop_states, cfg)

    def t_counted(states, loop_states, cfg):
        t_fired.append(int(states.odo.frame[0]))
        return t_real(states, loop_states, cfg)

    monkeypatch.setattr(j_fleet, "fleet_loop_step", j_counted)
    monkeypatch.setattr(fleet, "fleet_loop_step", t_counted)
    flags = ["--log", log] + FLEET + ([] if loops else ["--no-loop"])
    j_run.main(flags + ["--out-dir", str(tmp_path / "jax")])
    jax.effects_barrier()
    t_run.main(flags + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])

    poses = np.loadtxt(tmp_path / "port" / "fleet_final_poses.txt")
    poses_j = np.loadtxt(tmp_path / "jax" / "fleet_final_poses.txt")
    assert poses.shape == poses_j.shape == (2, 3) and np.isfinite(poses).all()
    np.testing.assert_array_equal(poses[0], poses[1])
    assert np.abs(poses - poses_j).max() <= GATE
    assert t_fired == j_fired
    assert len(j_fired) == (1 if loops else 0)
    recs = [[json.loads(x) for x in (tmp_path / d / "fleet_metrics.jsonl").read_text().splitlines()]
            for d in ("port", "jax")]
    assert [sorted(r) for r in recs[0]] == [sorted(r) for r in recs[1]]
    ((rec,), _) = recs
    assert rec["step"] == 3 and rec["robots"] == 2 and rec["cross_robot_spread_m"] == 0.0


def test_cli_fleet_chunked(log, tmp_path, monkeypatch):
    run_and_check(log, tmp_path, monkeypatch, loops=False)
