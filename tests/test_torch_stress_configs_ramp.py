"""The ramp of tests/test_stress_configs.py through the port against JAX
(tests/test_torch_stress_configs.py's gates): driving from flat ground onto
an 8.5 degree ramp must trip the odometry's ground-change machine in both
packages, on the same scan, with the JAX file's ATE bound.

The ramp is cut from 55 scans to the first 41: JAX's flag first turns on at
scan 40 (0-based), and the 14 scans after it add only run time.  The cast
scans are the JAX file's (its random stream is drawn in the same order).
"""
import numpy as np
import torch

from test_torch_robustness import JCFG, assert_tracks_jax
from test_torch_stress_configs_corridor import _drive
from rgc_slam_tpu.io.synthetic import World
from rgc_slam_tpu.utils.evaluation import ate_rmse

torch.set_num_threads(1)
RAMP_SCANS = 41


def test_ground_change_machine_on_ramp():
    wall_t, e = 0.4, 25.0
    world = World(
        boxes=np.array([
            [-e, -e, 0.0, e, -e + wall_t, 6.0],
            [-e, e - wall_t, 0.0, e, e, 6.0],
            [-e, -e, 0.0, -e + wall_t, e, 6.0],
            [e - wall_t, -e, 0.0, e, e, 6.0],
            [3.0, 3.0, 0.0, 5.0, 5.0, 2.0],
            [-5.0, -6.0, 0.0, -3.0, -4.0, 2.5],
        ]),
        box_albedo=np.array([60.0, 80.0, 60.0, 80.0, 150.0, 120.0]),
        cylinders=np.array([[6.0, -5.0, 0.3, 3.0], [-7.0, 5.0, 0.4, 3.0]]),
        cyl_albedo=np.array([200.0, 90.0]),
        ramp_x0=2.0,
        ramp_slope=0.15,
    )
    dt, speed = 0.1, 1.5
    poses = []
    for k in range(55):              # the JAX file's 55 poses, of which RAMP_SCANS run
        x = -4.0 + speed * dt * k
        z, pitch = ((0.0, 0.0) if x < world.ramp_x0
                    else (world.ramp_slope * (x - world.ramp_x0), -np.arctan(world.ramp_slope)))
        cp, sp = np.cos(pitch), np.sin(pitch)
        poses.append((np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]]),
                      np.array([x, 0.0, z + 0.56])))
    scans, _ = _drive(world, poses, dt, 1, JCFG, RAMP_SCANS)
    got, ref, _, (tflag, jflag) = assert_tracks_jax(scans, watch=lambda s: int(s.odo.gflag))
    assert max(jflag) == 1 and max(tflag) == 1, (jflag, tflag)
    assert tflag == jflag
    gt = np.stack([t for (_, t) in poses[:RAMP_SCANS]])
    ate_port, ate_jax = ate_rmse(got, gt), ate_rmse(ref, gt)
    assert ate_port < 0.25 and ate_jax < 0.25, (ate_port, ate_jax)
