"""State containers of the port: dataclasses of tensors.

Counterparts of ``rgc_slam_tpu/types.py``'s flax structs, with the same
field names, shapes and dtypes (float32, int32, bool), so the bridge
(``bridge.py``) moves JAX state into the port field by field.  Every
constructor takes an explicit ``device``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Iterator, Tuple

import torch


@dataclass
class Struct:
    """Base of every state container: ``replace`` mirrors flax's."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over dataclasses and (named) tuples of tensors
    with identical structure — the counterpart of ``jax.tree.map``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, tuple):
        vals = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield ``(dotted field path, tensor)`` leaves, e.g. ``"odo.sub_xyz"``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_items(getattr(tree, f.name), f"{prefix}{f.name}.")
    else:
        yield prefix[:-1], tree


def tree_where(pred: torch.Tensor, on_true, on_false):
    """Leafwise ``torch.where(pred, a, b)`` over two same-shaped trees."""
    return tree_map(lambda a, b: torch.where(pred, a, b), on_true, on_false)


@dataclass
class PointCloud(Struct):
    """Padded point cloud: xyz + per-point attributes + valid mask."""

    xyz: torch.Tensor         # [N, 3] float32
    intensity: torch.Tensor   # [N] float32
    rel_time: torch.Tensor    # [N] float32, fraction of sweep
    ring: torch.Tensor        # [N] int32
    mask: torch.Tensor        # [N] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.to(torch.int32).sum(-1)

    @classmethod
    def zeros(cls, n: int, device, dtype=torch.float32) -> "PointCloud":
        return cls(
            xyz=torch.zeros((n, 3), dtype=dtype, device=device),
            intensity=torch.zeros((n,), dtype=dtype, device=device),
            rel_time=torch.zeros((n,), dtype=dtype, device=device),
            ring=torch.zeros((n,), dtype=torch.int32, device=device),
            mask=torch.zeros((n,), dtype=torch.bool, device=device),
        )


@dataclass
class FeatureCloud(Struct):
    """Feature points with per-point confidence."""

    xyz: torch.Tensor         # [N, 3]
    rel_time: torch.Tensor    # [N]
    confidence: torch.Tensor  # [N]
    mask: torch.Tensor        # [N] bool

    @classmethod
    def zeros(cls, n: int, device, dtype=torch.float32) -> "FeatureCloud":
        return cls(
            xyz=torch.zeros((n, 3), dtype=dtype, device=device),
            rel_time=torch.zeros((n,), dtype=dtype, device=device),
            confidence=torch.zeros((n,), dtype=dtype, device=device),
            mask=torch.zeros((n,), dtype=torch.bool, device=device),
        )


@dataclass
class GroundPlane(Struct):
    """Per-scan ground-plane estimate (weighted-PCA eigenvectors)."""

    normal: torch.Tensor      # [3]
    v1: torch.Tensor          # [3]
    v2: torch.Tensor          # [3]
    distance: torch.Tensor    # []
    source: torch.Tensor      # [] 1 - confidence
    valid: torch.Tensor       # [] bool

    @classmethod
    def default(cls, lidar_height: float, device, dtype=torch.float32) -> "GroundPlane":
        f = dict(dtype=dtype, device=device)
        return cls(
            normal=torch.tensor([0.0, 0.0, 1.0], **f),
            v1=torch.tensor([1.0, 0.0, 0.0], **f),
            v2=torch.tensor([0.0, 1.0, 0.0], **f),
            distance=torch.tensor(lidar_height, **f),
            source=torch.tensor(0.0, **f),
            valid=torch.tensor(False, device=device),
        )


@dataclass
class ImuBatch(Struct):
    """Padded IMU sample window between two scans."""

    t: torch.Tensor           # [M]
    acc: torch.Tensor         # [M, 3]
    gyr: torch.Tensor         # [M, 3]
    mask: torch.Tensor        # [M] bool

    @classmethod
    def zeros(cls, m: int, device, dtype=torch.float32) -> "ImuBatch":
        return cls(
            t=torch.zeros((m,), dtype=dtype, device=device),
            acc=torch.zeros((m, 3), dtype=dtype, device=device),
            gyr=torch.zeros((m, 3), dtype=dtype, device=device),
            mask=torch.zeros((m,), dtype=torch.bool, device=device),
        )


@dataclass
class VoxelMap(Struct):
    """Gaussian voxel map: open-addressing hash of per-voxel moments."""

    keys: torch.Tensor        # [CAP] int32 packed voxel coords (-1 = empty)
    mean: torch.Tensor        # [CAP, 3]
    cov: torch.Tensor         # [CAP, 3, 3]
    num_points: torch.Tensor  # [CAP] float32
    resolution: torch.Tensor  # [] float32
