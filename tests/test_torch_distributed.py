"""The port's sharded engine over torch.distributed: ``slam_step`` with the
sp front-end on 2 gloo ranks, and ``fleet.make_distributed_step`` on a
2 x 2 (dp x sp) mesh of 4 ranks, against the port on one process and
against JAX.

Inputs are tests/test_fleet.py's (``_inputs``: 3 scans of 120 azimuth,
seed 7, every robot the same scans) at TEST_CONFIG.  Gates, from the JAX
suite: the sharded step within 1e-4 m of the replicated one
(tests/test_features_sp.py:270-272) and every rank bit-equal; the dp x sp
fleet within 5e-3 m of the one-process fleet, its mean fitness within 1e-3
(tests/test_fleet.py:56-76); against JAX, 5e-3 m (the graft entry's
multichip gate, __graft_entry__.py:141-145).  JAX's sharded step runs under
``shard_map`` on the conftest's virtual CPU mesh.  The ranks are spawned
processes (``parallel.distributed.run_ranks``) running
tests/torch_sp_ranks.py.
"""
import dataclasses
import functools
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_sp_ranks as ranks
from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud, imu_from_interval as j_imu
from rgc_slam_tpu.models import slam as jslam
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud, imu_from_interval as t_imu
from rgc_slam_tpu_torch.models import slam as tslam
from rgc_slam_tpu_torch.parallel import fleet as tfleet
from rgc_slam_tpu_torch.parallel.distributed import run_ranks
from rgc_slam_tpu_torch.types import tree_items, tree_stack

torch.set_num_threads(1)
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(
        n_scans=3, n_azimuth=120, seed=7, extent=15.0, radius=6.0,
        noise=0.004, closes_loop=False, speed=1.5,
    )


def _port_inputs(seq, k):
    t_i, acc, gyr = seq["imu"][k]
    return (t_cloud(seq["scans"][k], TCFG, "cpu"), t_imu(t_i, acc, gyr, TCFG.max_imu, "cpu"),
            float(seq["stamps"][k]))


def _numpy_scans(seq):
    out = []
    for k in range(len(seq["scans"])):
        cloud, imu, stamp = _port_inputs(seq, k)
        out.append(({n: v.numpy() for n, v in tree_items(cloud)},
                    {n: v.numpy() for n, v in tree_items(imu)}, stamp))
    return out


def _jax_inputs(seq, k):
    t_i, acc, gyr = seq["imu"][k]
    return (j_cloud(seq["scans"][k], JCFG), j_imu(t_i, acc, gyr, JCFG.max_imu),
            jnp.asarray(seq["stamps"][k], jnp.float32))


@pytest.fixture(scope="module")
def jax_single(seq):
    step = jax.jit(functools.partial(jslam.slam_step, cfg=JCFG))
    state, out_t = jslam.SlamState.init(JCFG), []
    for k in range(len(seq["scans"])):
        state, out = step(state, *_jax_inputs(seq, k))
        out_t.append(np.asarray(out.t_map))
    return np.stack(out_t)


@pytest.fixture(scope="module")
def port_single(seq):
    state, out_t = tslam.SlamState.init(TCFG, "cpu"), []
    for k in range(len(seq["scans"])):
        cloud, imu, stamp = _port_inputs(seq, k)
        state, out = tslam.slam_step(state, cloud, imu, torch.tensor(stamp), TCFG)
        out_t.append(out.t_map.numpy())
    return np.stack(out_t)


def test_slam_step_sp_features(seq, port_single):
    """slam_step with the sp front-end on a 2-rank sp mesh: both ranks the
    same bits, within 1e-4 m of the replicated port, within 5e-3 m of JAX's
    shard_map'd step on the same inputs."""
    cfg = dataclasses.replace(TCFG, psum_axis="sp", sp_shards=2, sp_features=True)
    outs = run_ranks(ranks.slam_sp, 2, "cpu", (_numpy_scans(seq), cfg), timeout_s=TIMEOUT_S)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.isfinite(outs[0]).all()
    np.testing.assert_allclose(outs[0], port_single, atol=1e-4)

    jcfg = dataclasses.replace(JCFG, psum_axis="sp", sp_shards=2, sp_features=True)
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("sp",))
    sp_step = jax.jit(jax.shard_map(functools.partial(jslam.slam_step, cfg=jcfg), mesh=mesh,
                                    in_specs=P(), out_specs=P()))
    state, jt = jslam.SlamState.init(jcfg), []
    for k in range(len(seq["scans"])):
        state, out = sp_step(state, *_jax_inputs(seq, k))
        jt.append(np.asarray(out.t_map))
    np.testing.assert_allclose(outs[0], np.stack(jt), atol=5e-3)


def test_distributed_step_2x2(seq, jax_single):
    """make_distributed_step on a 2 x 2 mesh, 4 robots on the same scans:
    the sp ranks of a dp row agree bit for bit, every robot tracks the
    one-process fleet and JAX's single stream, and the dp-summed mean
    fitness is the fleet's."""
    n_robots = 4
    outs = run_ranks(ranks.distributed_fleet, 4, "cpu",
                     (_numpy_scans(seq), TCFG, 2, 2, n_robots), timeout_s=TIMEOUT_S)
    for d in range(2):                              # rank = dp * 2 + sp
        np.testing.assert_array_equal(outs[2 * d][0], outs[2 * d + 1][0])
    t_map = np.concatenate([outs[0][0], outs[2][0]], axis=1)   # [scans, robots, 3]
    fitness = np.concatenate([outs[0][1], outs[2][1]])
    assert np.isfinite(t_map).all()

    states = tfleet.fleet_init(TCFG, n_robots, "cpu")
    for k in range(len(seq["scans"])):
        cloud, imu, stamp = _port_inputs(seq, k)
        states, ref = tfleet.fleet_step(states, tree_stack([cloud] * n_robots),
                                        tree_stack([imu] * n_robots),
                                        torch.full((n_robots,), stamp), TCFG)
    np.testing.assert_allclose(t_map[-1], ref.t_map.numpy(), atol=5e-3)
    for o in outs:
        assert abs(o[2] - float(ref.fitness.mean())) <= 1e-3
        assert abs(o[2] - float(fitness.mean())) <= 1e-6
    for b in range(n_robots):
        np.testing.assert_allclose(t_map[:, b], jax_single, atol=5e-3)


def test_failing_rank_fails_the_call():
    """A rank that raises fails run_ranks with its exception, within the
    timeout, while the other rank waits in a collective."""
    start = time.monotonic()
    with pytest.raises(ValueError, match="fails on purpose") as info:
        run_ranks(ranks.raises_on_one_rank, 2, "cpu", timeout_s=60)
    assert time.monotonic() - start < 60
    assert any("rank 1 of 2" in note for note in info.value.__notes__)
