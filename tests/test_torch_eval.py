"""``rgc_slam_tpu_torch.tools.eval`` against the JAX package's ``eval.py``.

* The configurations of the evaluation programs equal the root scripts'
  field by field: ``eval.BASE`` and each gate's configuration,
  ``eval_longrun.CFG``, ``eval_longrun_fleet``'s constants and ``CFG``,
  ``eval_sp.CFG``.
* ``sequence(gate, quick=True)``: its first 3 scans (points, rings,
  intensities, sweep times, masks), IMU windows, stamps and poses equal,
  bit for bit, the JAX package's ``io.synthetic`` called with the
  arguments of ``eval.py:166-171, 187-194, 208-241, 259-262, 278-281``
  (5b's courses: tests/test_torch_eval_fleet.py).
* ``run_sequence`` against ``eval.run_sequence`` on a small configuration
  over 12 scans with a loop step after scan 10: ``n_scans`` and ``path_m``
  equal, ``n_loops`` equal, and the ATE (map and odometry) and RPE within
  PERF.md §2's rule read both ways, |port - JAX| <= 0.05 x JAX + 0.01 m.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rgc_slam_tpu import config as jcfg
from rgc_slam_tpu.io import synthetic as jsyn
from rgc_slam_tpu_torch import config as tcfg
from rgc_slam_tpu_torch.io import synthetic as tsyn
from rgc_slam_tpu_torch.tools import eval as teval
from rgc_slam_tpu_torch.tools import eval_longrun, eval_longrun_fleet, eval_sp

import torch_eval_roots

torch.set_num_threads(1)
SCAN_KEYS = ("xyz", "intensity", "ring", "rel_time", "mask")


def _asdict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", ["BASE", "gates", "longrun", "longrun_fleet", "sp"])
def test_configs_match_the_root_scripts(name):
    if name == "BASE":
        assert _asdict(teval.BASE) == _asdict(torch_eval_roots.load("eval").BASE)
    elif name == "gates":
        # each gate's configuration as eval.py builds it (eval.py:172-313)
        jbase = torch_eval_roots.load("eval").BASE
        bench = torch_eval_roots.load("bench")
        cfg1 = dataclasses.replace(jbase, loop_closure_enable=False)
        expect = {
            "1": cfg1, "1p": dataclasses.replace(cfg1, imu_cov_mode="preint"),
            "2": jbase, "3": jbase, "3l1": dataclasses.replace(jbase, mapping_loss="l1"),
            "4": dataclasses.replace(jbase, n_scans=64, use_imu=False, use_ground=False,
                                     loop_closure_enable=False, max_points=65536),
            "5_fleet": bench.FLEET_CONFIG,
            "5b": dataclasses.replace(jbase, inline_compaction=False, max_keyframes=256),
        }
        assert set(expect) == set(teval.GATES)
        for gate, cfg in expect.items():
            assert _asdict(teval.gate_config(gate)) == _asdict(cfg), gate
        assert teval.loop_every("2") == jbase.loop_cadence and teval.loop_every("1") == 0
    elif name == "longrun":
        j = torch_eval_roots.load("eval_longrun")
        assert _asdict(eval_longrun.CFG) == _asdict(j.CFG)
        assert eval_longrun.N_SCANS == j.N_SCANS == 2000
    elif name == "longrun_fleet":
        j = torch_eval_roots.load("eval_longrun_fleet")
        for const in ("B", "N_SCANS", "N_SEEDS", "KF_CAP", "LOOP_EVERY"):
            assert getattr(eval_longrun_fleet, const) == getattr(j, const), const
        assert _asdict(eval_longrun_fleet.CFG) == _asdict(j.CFG)
    else:
        cfg = torch_eval_roots.assigned("eval_sp", "CFG", {"SlamConfig": jcfg.SlamConfig})
        assert _asdict(eval_sp.CFG) == _asdict(cfg)
        for const in ("N_WARM", "N_TIMED", "N_REPS"):
            assert getattr(eval_sp, const) == torch_eval_roots.assigned("eval_sp", const, {}), const


def _jax_corridor(n_leg):
    """eval.py:208-241, with the JAX package's synthetic module."""
    world3 = jsyn.corridor_world(length=70.0, width=8.0, alcove_spacing=24.0)

    def _yaw_R(th):
        c, s = np.cos(th), np.sin(th)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    poses3 = []
    for k in range(n_leg):
        poses3.append((np.eye(3), np.array([-25.0 + 0.4 * k, 0.0, 0.56])))
    x_turn = poses3[-1][1][0]
    for k in range(1, 26):
        th = np.pi * k / 25.0
        poses3.append((_yaw_R(th), np.array([x_turn, 0.0, 0.56])))
    for k in range(1, n_leg + 1):
        poses3.append((_yaw_R(np.pi), np.array([x_turn - 0.4 * k, 0.0, 0.56])))
    n3 = len(poses3)
    imu3 = jsyn.synthesize_imu(poses3, 0.1)
    rng3 = np.random.default_rng(23)
    return {
        "scans": [jsyn.cast_scan(world3, R, t, n_rings=16, n_azimuth=900, rng=rng3, noise=0.01)
                  for (R, t) in poses3],
        "imu": [imu3[max(k - 1, 0)] for k in range(n3)],
        "stamps": [0.1 * (k + 1) for k in range(n3)],
        "poses": poses3,
    }


# eval.py's quick sequences (q=True), gate by gate
JAX_QUICK = {
    "1": lambda: jsyn.generate_sequence(
        n_scans=60, n_azimuth=900, seed=21, extent=30.0, radius=12.0, noise=0.01,
        closes_loop=False, speed=2.0),
    "2": lambda: jsyn.generate_sequence(
        n_scans=120, n_azimuth=900, seed=22, extent=26.0, radius=10.0, noise=0.01,
        closes_loop=True, laps=1.6),
    "3": lambda: _jax_corridor(20),
    "4": lambda: jsyn.generate_sequence(
        n_scans=30, n_rings=64, n_azimuth=900, seed=24, extent=45.0, radius=18.0, noise=0.01,
        closes_loop=False, speed=2.5),
    "5_fleet": lambda: jsyn.generate_sequence(
        n_scans=6, n_azimuth=900, seed=21, extent=30.0, radius=12.0, noise=0.01,
        closes_loop=False, speed=2.0),
}
_jax_cache = {}


def assert_same_head(port, ref, n=3):
    """The first ``n`` scans of two sequences equal bit for bit, and their
    lengths."""
    assert len(port["scans"]) == len(ref["scans"])
    for k in range(n):
        for key in SCAN_KEYS:
            a, b = port["scans"][k][key], ref["scans"][k][key]
            assert a.dtype == b.dtype and np.array_equal(a, b), (k, key)
        for a, b in zip(port["imu"][k], ref["imu"][k]):
            assert np.array_equal(a, b), k
        assert port["stamps"][k] == ref["stamps"][k]
        for a, b in zip(port["poses"][k], ref["poses"][k]):
            assert np.array_equal(a, b), k


@pytest.mark.parametrize("gate", ["1", "1p", "2", "3", "3l1", "4", "5_fleet"])
def test_quick_sequence_matches_eval_py(gate):
    shared = {"1p": "1", "3l1": "3"}.get(gate, gate)
    if shared not in _jax_cache:
        _jax_cache.clear()
        _jax_cache[shared] = JAX_QUICK[shared]()
    assert_same_head(teval.sequence(gate, True), _jax_cache[shared])


def test_sequence_rejects_an_unknown_gate():
    with pytest.raises(ValueError, match="unknown gate"):
        teval.sequence("6", True)


def test_run_sequence_matches_eval_py():
    jeval = torch_eval_roots.load("eval")
    cfg_t = dataclasses.replace(tcfg.TEST_CONFIG, max_keyframes=32)
    cfg_j = jcfg.SlamConfig(**_asdict(cfg_t))
    seq = tsyn.generate_sequence(n_scans=13, n_azimuth=240, seed=5, extent=18.0, radius=8.0,
                                 noise=0.004, closes_loop=False, speed=2.0)
    port = teval.run_sequence(cfg_t, seq, loop_every=10, device="cpu")
    ref = jeval.run_sequence(cfg_j, seq, loop_every=10)
    assert port["n_scans"] == ref["n_scans"] == 12 and port["path_m"] == ref["path_m"]
    assert port["n_loops"] == ref["n_loops"]
    assert port["mapping_loss"] == ref["mapping_loss"]
    assert (port["loop_fitness_accepted_max"] is None) == (ref["loop_fitness_accepted_max"] is None)
    for key in ("ate_map_m", "ate_odom_m", "rpe_map_m"):
        assert abs(port[key] - ref[key]) <= 0.05 * ref[key] + 0.01, (key, port[key], ref[key])
    assert set(ref) <= set(port) and port["ms_per_scan"] > 0
