"""Chunked dispatch of the port: ``SlamSystem(chunk=3)`` and ``make_chunk_step``.

Scans 0-6 go through two ``process_chunk`` calls and one ``process``:
* loops off, the trajectory is bit-equal to ``chunk=1`` on the CPU (the
  chunk runs the same steps one after another);
* loops on with ``loop_cadence=2`` (not dividing the chunk), the loop steps
  run after each chunk, once per cadence boundary it crossed, at the same
  scan counts as in the JAX package's ``SlamSystem(chunk=3)``, and
  ``loop_info`` holds the last one's;
* both hold against the JAX package's ``SlamSystem(chunk=3)`` within
  tests/test_torch_slam.py's early-scan gate, 5e-3 m.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud, imu_from_interval as j_imu
from rgc_slam_tpu.models import slam as jslam
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud, imu_from_interval as t_imu
from rgc_slam_tpu_torch.models import slam as tslam

torch.set_num_threads(1)
CADENCE = 2
GATE = 5e-3


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_scans=9, n_azimuth=120, seed=9, extent=15.0, radius=6.0,
                                       noise=0.004, closes_loop=False, speed=1.5)


def _feed(system, items, fired):
    system.process_chunk(items[0:3])
    fired.append(("chunk", system._frame))
    system.process_chunk(items[3:6])
    fired.append(("chunk", system._frame))
    system.process(*items[6])
    return np.stack([t for _, _, t in system.trajectory]), np.stack(
        [t for _, _, t in system.odom_trajectory])


@pytest.fixture(scope="module")
def jax_run(seq):
    """The JAX SlamSystem(chunk=3), loops on at CADENCE: (map and odom
    trajectories, the scan count at each loop step)."""
    cfg = dataclasses.replace(JCFG, loop_cadence=CADENCE)
    items = []
    for k in range(7):
        t_i, acc, gyr = seq["imu"][k]
        items.append((j_cloud(seq["scans"][k], cfg), j_imu(t_i, acc, gyr, cfg.max_imu),
                      seq["stamps"][k]))
    system = jslam.SlamSystem(cfg, enable_loop=True, chunk=3)
    loop_fn, fired = system._loop_fn, []

    def spy(state, ls):
        fired.append(("loop", system._frame))
        return loop_fn(state, ls)

    system._loop_fn = spy
    t_map, t_odom = _feed(system, items, fired)
    return t_map, t_odom, fired


def _port_items(seq, cfg):
    items = []
    for k in range(7):
        t_i, acc, gyr = seq["imu"][k]
        items.append((t_cloud(seq["scans"][k], cfg, "cpu"), t_imu(t_i, acc, gyr, cfg.max_imu, "cpu"),
                      seq["stamps"][k]))
    return items


def test_chunked_bit_equal_to_unchunked(seq, jax_run):
    cfg = dataclasses.replace(TCFG, loop_cadence=CADENCE)
    items = _port_items(seq, cfg)
    one = tslam.SlamSystem(cfg, enable_loop=False, device="cpu")
    for item in items:
        one.process(*item)
    chunked = tslam.SlamSystem(cfg, enable_loop=False, chunk=3, device="cpu")
    t_map, t_odom = _feed(chunked, items, [])
    for a, b in ((one.trajectory, chunked.trajectory), (one.odom_trajectory, chunked.odom_trajectory)):
        assert [s for s, _, _ in a] == [s for s, _, _ in b]
        for (_, qa, ta), (_, qb, tb) in zip(a, b):
            np.testing.assert_array_equal(qa, qb)
            np.testing.assert_array_equal(ta, tb)
    for tensor_a, tensor_b in zip(torch.utils._pytree.tree_leaves(one.state),
                                  torch.utils._pytree.tree_leaves(chunked.state)):
        assert torch.equal(tensor_a, tensor_b)
    assert np.abs(t_map - jax_run[0]).max() <= GATE
    assert np.abs(t_odom - jax_run[1]).max() <= GATE


def test_chunked_loop_steps_fire_as_jax(seq, jax_run):
    cfg = dataclasses.replace(TCFG, loop_cadence=CADENCE)
    system = tslam.SlamSystem(cfg, enable_loop=True, chunk=3, device="cpu")
    fired, infos = [], []
    loop_step = system.loop_step

    def spy():
        fired.append(("loop", system._frame))
        info = loop_step()
        infos.append(info)
        return info

    system.loop_step = spy
    items = _port_items(seq, cfg)
    system.process_chunk(items[0:3])
    fired.append(("chunk", system._frame))
    assert system.loop_info is infos[-1]
    system.process_chunk(items[3:6])
    fired.append(("chunk", system._frame))
    assert len(infos) == 3 and system.loop_info is infos[-1]
    system.process(*items[6])
    assert system.loop_info is None               # scan 7 crosses no cadence boundary
    # 3 // 2 = 1 boundary in the first chunk, 6 // 2 - 3 // 2 = 2 in the second
    assert fired == jax_run[2] == [("loop", 3), ("chunk", 3), ("loop", 6), ("loop", 6),
                                   ("chunk", 6)]
    t_map = np.stack([t for _, _, t in system.trajectory])
    assert np.abs(t_map - jax_run[0]).max() <= GATE
    assert int(system.loop_state.last_kf_count) == int(system.state.mapping.kf_count)


def test_process_chunk_takes_exactly_chunk_items(seq):
    cfg = dataclasses.replace(TCFG, loop_cadence=CADENCE)
    items = _port_items(seq, cfg)[:2]
    with pytest.raises(ValueError, match="chunk=3"):
        tslam.SlamSystem(cfg, enable_loop=False, chunk=3, device="cpu").process_chunk(items)
    with pytest.raises(ValueError, match="chunk=1"):
        tslam.SlamSystem(cfg, enable_loop=False, device="cpu").process_chunk(items[:1])
    step = tslam.make_chunk_step(lambda state, c, i, s: (state + 1, s), 2)
    assert step(0, "c0", "i0", 10, "c1", "i1", 11) == (2, [10, 11])
