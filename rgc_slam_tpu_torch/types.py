"""State containers of the port: dataclasses of tensors.

Counterparts of ``rgc_slam_tpu/types.py``'s flax structs, with the same
field names, shapes and dtypes (float32, int32, bool), so the bridge
(``bridge.py``) moves JAX state into the port field by field.  Every
constructor takes an explicit ``device``.  Every ``Struct`` subclass is a
pytree node (``torch.utils._pytree``), so ``torch.func.vmap`` takes and
returns whole states, as ``jax.vmap`` does with flax structs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence, Tuple

import torch
import torch.utils._pytree as pytree


def _flatten(node):
    names = tuple(f.name for f in dataclasses.fields(node))
    return [getattr(node, n) for n in names], names


def _flatten_with_keys(node):
    values, names = _flatten(node)
    return [(pytree.GetAttrKey(n), v) for n, v in zip(names, values)], names


def _register(cls):
    pytree.register_pytree_node(
        cls, _flatten, lambda values, names: cls(**dict(zip(names, values))),
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}",
        flatten_with_keys_fn=_flatten_with_keys,
    )


@dataclass
class Struct:
    """Base of every state container: ``replace`` mirrors flax's.  A
    subclass registers itself as a pytree node; its fields are read when a
    node is flattened, after ``@dataclass`` has made them."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _register(cls)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure (``Struct``s,
    (named) tuples) — the counterpart of ``jax.tree.map``."""
    return pytree.tree_map(fn, tree, *rest)


def tree_items(tree) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield ``(dotted field path, tensor)`` leaves of a ``Struct``, e.g.
    ``"odo.sub_xyz"``."""
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        yield pytree.keystr(path)[1:], leaf


def tree_where(pred: torch.Tensor, on_true, on_false):
    """Leafwise ``torch.where(pred, a, b)`` over two same-shaped trees."""
    return tree_map(lambda a, b: torch.where(pred, a, b), on_true, on_false)


def tree_stack(trees: Sequence):
    """Stack same-shaped trees leafwise along a new leading axis: B states
    -> one batched state (fresh storage, no lane aliases another)."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def tree_index(tree, i):
    """Leafwise ``leaf[i]``: lane ``i`` of a batched tree (a view)."""
    return tree_map(lambda leaf: leaf[i], tree)


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
class Pose(Struct):
    """SE(3) pose as quaternion [w, x, y, z] + translation."""

    q: torch.Tensor           # [4]
    t: torch.Tensor           # [3]

    @classmethod
    def identity(cls, device, dtype=torch.float32) -> "Pose":
        return cls(q=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device),
                   t=torch.zeros((3,), dtype=dtype, device=device))


@dataclass
class VoxelMap(Struct):
    """Gaussian voxel map: open-addressing hash of per-voxel moments."""

    keys: torch.Tensor        # [CAP] int32 packed voxel coords (-1 = empty)
    mean: torch.Tensor        # [CAP, 3]
    cov: torch.Tensor         # [CAP, 3, 3]
    num_points: torch.Tensor  # [CAP] float32
    resolution: torch.Tensor  # [] float32


@dataclass
class Scan(Struct):
    """One raw sweep, fixed shape: the input of the whole pipeline."""

    cloud: PointCloud
    imu: ImuBatch
    stamp: torch.Tensor       # [] scan end time
