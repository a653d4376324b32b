"""Off-default engine configurations through the port against JAX: the
scenarios of tests/test_stress_configs.py on the same inputs, here the
64-beam KITTI-style sweeps without IMU or ground and the 32-beam sweeps
(tests/test_torch_stress_configs_corridor.py holds the degraded corridor,
its l1 loss and the ground-change ramp).

Each scenario keeps its config and its scans and must reach its condition
in both packages (here the JAX file's ATE bound); the port's ``t_map`` is
held scan by scan and axis by axis to tests/test_torch_slam.py's gate of
JAX's, max(5e-3 m, twice JAX's own deviation on that axis under 1e-7
perturbations of every scan, two seeds), through
tests/test_torch_robustness.py's helper.
"""
import dataclasses

import numpy as np
import torch

from test_torch_robustness import JCFG, TCFG, as_numpy, assert_tracks_jax, seq_inputs
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.utils.evaluation import ate_rmse

torch.set_num_threads(1)
KITTI = dict(n_scans=64, use_imu=False, use_ground=False, use_intensity=False, max_points=16384)


def _sequence_scans(seq, jcfg):
    return [as_numpy(*seq_inputs(seq, k, jcfg)) for k in range(len(seq["scans"]))]


def _ates(seq, got, ref):
    gt = np.stack([t for (_, t) in seq["poses"]])
    return ate_rmse(got, gt), ate_rmse(ref, gt)


def test_kitti_style_64beam_no_imu_no_ground():
    jcfg, tcfg = (dataclasses.replace(c, **KITTI) for c in (JCFG, TCFG))
    seq = synthetic.generate_sequence(
        n_scans=16, n_rings=64, n_azimuth=240, seed=9, extent=18.0, radius=7.0,
        noise=0.004, motion_distortion=True, closes_loop=False, speed=2.0,
    )
    got, ref = assert_tracks_jax(_sequence_scans(seq, jcfg), jcfg, tcfg)[:2]
    ate_port, ate_jax = _ates(seq, got, ref)
    assert ate_port < 0.2 and ate_jax < 0.2, (ate_port, ate_jax)


def test_32beam_pipeline():
    jcfg, tcfg = (dataclasses.replace(c, n_scans=32) for c in (JCFG, TCFG))
    seq = synthetic.generate_sequence(
        n_scans=6, n_rings=32, n_azimuth=240, seed=13, extent=18.0, radius=7.0,
        noise=0.004, motion_distortion=True, closes_loop=False, speed=2.0,
    )
    got, ref = assert_tracks_jax(_sequence_scans(seq, jcfg), jcfg, tcfg)[:2]
    ate_port, ate_jax = _ates(seq, got, ref)
    assert ate_port < 0.25 and ate_jax < 0.25, (ate_port, ate_jax)
