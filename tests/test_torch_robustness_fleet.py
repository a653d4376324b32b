"""Degenerate inputs through the port against JAX, continued from
tests/test_torch_robustness.py (same gates): an all-ground world, a fleet
with one dead robot (through the port's ``parallel/fleet.fleet_step``), and
an empty IMU batch mid-run, as tests/test_robustness.py runs them.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from test_torch_robustness import (JCFG, TCFG, as_numpy, assert_tracks_jax, jax_args,
                                   perturbed, port_args, seq_inputs)
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict
from rgc_slam_tpu.io.synthetic import World
from rgc_slam_tpu.parallel import fleet as jfleet
from rgc_slam_tpu.types import ImuBatch
from rgc_slam_tpu_torch.parallel import fleet as tfleet
from rgc_slam_tpu_torch.types import tree_stack

torch.set_num_threads(1)


def test_all_ground_scan():
    """Only floor: the mapping skip gate holds the pose, the ground plane
    is seen in both packages."""
    world = World(boxes=np.zeros((0, 6)), box_albedo=np.zeros((0,)),
                  cylinders=np.zeros((0, 4)), cyl_albedo=np.zeros((0,)))
    rng = np.random.default_rng(3)
    m = JCFG.max_imu
    scans = []
    for k in range(4):
        scan = synthetic.cast_scan(world, np.eye(3), np.array([0.1 * k, 0.0, 0.56]),
                                   n_rings=16, n_azimuth=240, rng=rng, noise=0.004)
        imu = ImuBatch(t=jnp.asarray(0.1 * k + 0.005 * np.arange(m), jnp.float32),
                       acc=jnp.tile(jnp.asarray([0, 0, 9.81], jnp.float32), (m, 1)),
                       gyr=jnp.zeros((m, 3), jnp.float32), mask=jnp.ones((m,), bool))
        scans.append(as_numpy(cloud_from_scan_dict(scan, JCFG), imu, 0.1 * (k + 1)))
    state = assert_tracks_jax(scans)[2]
    assert bool(state.odo.ground_last.valid)


def test_fleet_zero_feature_robot():
    """Three robots, robot 1 fed fully masked scans: the port's fleet holds
    it (|t| < 1 m), its healthy robots are each other's bits, and every
    robot tracks JAX's fleet under the module's gate."""
    jcfg = dataclasses.replace(JCFG, inline_compaction=False)
    tcfg = dataclasses.replace(TCFG, inline_compaction=False)
    B = 3
    seq = synthetic.generate_sequence(
        n_scans=5, n_azimuth=240, seed=35, extent=16.0, radius=6.0,
        noise=0.004, closes_loop=False, speed=1.5,
    )
    robots = []                      # per scan, per robot: the numpy inputs
    for k in range(len(seq["scans"])):
        cloud, imu, stamp = seq_inputs(seq, k, jcfg)
        alive = as_numpy(cloud, imu, stamp)
        dead = as_numpy(cloud.replace(mask=jnp.zeros_like(cloud.mask)), imu, stamp)
        robots.append([alive, dead, alive])

    jstep = jax.jit(functools.partial(jfleet.fleet_step, cfg=jcfg))

    def run_jax(per_scan):
        states, traj = jfleet.fleet_init(jcfg, B), []
        for row in per_scan:
            args = [jax_args(r) for r in row]
            batch = [jax.tree.map(lambda *a: jnp.stack(a), *[a[i] for a in args])
                     for i in range(3)]
            states, outs = jstep(states, *batch)
            traj.append(np.asarray(outs.t_map))
        return np.stack(traj)                     # [scans, B, 3]

    ref = run_jax(robots)
    env = np.zeros(ref.shape)
    for seed in (1, 2):
        moved = run_jax([[perturbed(r, seed) for r in row] for row in robots])
        env = np.maximum(env, np.abs(moved - ref))

    states, got = tfleet.fleet_init(tcfg, B, "cpu"), []
    for row in robots:
        args = [port_args(r) for r in row]
        batch = [tree_stack([a[i] for a in args]) for i in range(3)]
        states, outs = tfleet.fleet_step(states, *batch, tcfg)
        got.append(outs.t_map.numpy())
    got = np.stack(got)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    np.testing.assert_array_equal(got[:, 0], got[:, 2])
    assert (np.linalg.norm(got[:, 1], axis=-1) < 1.0).all(), got[:, 1]
    dev = np.abs(got - ref)
    assert (dev <= np.maximum(5e-3, 2 * env)).all(), (dev, env)


def test_empty_imu_batch_mid_run():
    seq = synthetic.generate_sequence(
        n_scans=6, n_azimuth=240, seed=32, extent=16.0, radius=6.0,
        noise=0.004, closes_loop=False, speed=1.5,
    )
    m = JCFG.max_imu
    empty = ImuBatch(t=jnp.zeros((m,), jnp.float32), acc=jnp.zeros((m, 3), jnp.float32),
                     gyr=jnp.zeros((m, 3), jnp.float32), mask=jnp.zeros((m,), bool))
    scans = []
    for k in range(len(seq["scans"])):
        cloud, imu, stamp = seq_inputs(seq, k)
        scans.append(as_numpy(cloud, empty if k == 2 else imu, stamp))
    assert_tracks_jax(scans)
