"""The port's ``Pose`` and ``Scan`` containers against ``rgc_slam_tpu/types.py``:
the same fields, and whole containers through the pytree functions and
``torch.func.vmap`` as flax structs go through ``jax.tree`` and ``jax.vmap``."""
import dataclasses

import numpy as np
import jax
import torch
import torch.utils._pytree as pytree

from rgc_slam_tpu import types as jtypes
from rgc_slam_tpu_torch import types as ttypes
from rgc_slam_tpu_torch.config import TEST_CONFIG
from rgc_slam_tpu_torch.io import synthetic
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval


def _scan():
    seq = synthetic.generate_sequence(n_scans=2, n_azimuth=120, seed=5, extent=18.0, radius=8.0,
                                      noise=0.004, closes_loop=False, speed=2.0)
    t, a, g = seq["imu"][0]
    return ttypes.Scan(cloud=cloud_from_scan_dict(seq["scans"][0], TEST_CONFIG, "cpu"),
                       imu=imu_from_interval(t, a, g, TEST_CONFIG.max_imu, "cpu"),
                       stamp=torch.tensor(seq["stamps"][0], dtype=torch.float32))


def test_fields_match_jax():
    for name in ("Pose", "Scan"):
        assert ([f.name for f in dataclasses.fields(getattr(ttypes, name))]
                == [f.name for f in dataclasses.fields(getattr(jtypes, name))]), name


def test_pose_identity_matches_jax():
    t, j = ttypes.Pose.identity("cpu"), jtypes.Pose.identity()
    for name in ("q", "t"):
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


def test_pytree_round_trip():
    pose = ttypes.Pose(q=torch.tensor([0.5, 0.5, 0.5, 0.5]), t=torch.tensor([1.0, 2.0, 3.0]))
    scan = _scan()
    for tree in (pose, scan):
        leaves, spec = pytree.tree_flatten(tree)
        back = pytree.tree_unflatten(leaves, spec)
        assert type(back) is type(tree)
        assert [k for k, _ in ttypes.tree_items(back)] == [k for k, _ in ttypes.tree_items(tree)]
        assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(back), leaves))
    keys = [k for k, _ in ttypes.tree_items(scan)]
    assert keys[:2] == ["cloud.xyz", "cloud.intensity"] and keys[-1] == "stamp"
    assert len(jax.tree_util.tree_leaves(jtypes.Pose.identity())) == len(pytree.tree_leaves(pose))


def test_vmap_and_stack():
    """Two poses stacked into one batched Pose, moved under vmap, and read
    back lane by lane."""
    poses = [ttypes.Pose.identity("cpu"), ttypes.Pose(q=torch.tensor([0.0, 1.0, 0.0, 0.0]),
                                                      t=torch.tensor([1.0, 0.0, 0.0]))]
    batch = ttypes.tree_stack(poses)
    assert batch.q.shape == (2, 4) and batch.t.shape == (2, 3)
    moved = torch.func.vmap(lambda p: p.replace(t=p.t + 1.0))(batch)
    assert isinstance(moved, ttypes.Pose)
    for b, pose in enumerate(poses):
        lane = ttypes.tree_index(moved, b)
        assert torch.equal(lane.q, pose.q) and torch.equal(lane.t, pose.t + 1.0)
    scans = ttypes.tree_stack([_scan(), _scan()])
    assert scans.cloud.xyz.shape[0] == 2 and scans.stamp.shape == (2,)
