"""Named mesh axes: the port's counterpart of ``shard_map``'s axis names.

In the JAX package ``cfg.psum_axis = "sp"`` names a mesh axis inside
``shard_map``, and ``jax.lax.psum`` / ``axis_index`` / ``axis_size`` read
it.  Here an axis name resolves to a ``torch.distributed`` process group:

* ``active(mesh)`` names the groups of a ``parallel.distributed.Mesh``
  ``"dp"`` and ``"sp"`` for the code it runs, as ``shard_map`` binds its
  axis names;
* ``psum(x, axis)`` all-reduces ``x`` over the named group (one
  collective, also under ``torch.func.vmap``: its vmap rule reduces the
  whole batched tensor at once); ``axis_index`` and ``axis_size`` are
  this rank's coordinate and the axis's extent, plain integers, so a
  block slice is a static slice;
* ``sp_group()`` is the active sp group, if it spans ranks
  (``utils.lanes.any_lane`` agrees its predicates over it).

The engine needs no collective but all-reduce: the JAX package gathers
per-point blocks with a psum of zero-padded buffers
(``rgc_slam_tpu/ops/features.py:456-470``), and so does the port.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional

import torch
import torch.distributed as dist

_ACTIVE: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar("rgc_mesh", default=None)


@contextlib.contextmanager
def active(mesh):
    """Within the block, the axis names ``"dp"`` and ``"sp"`` resolve to
    ``mesh``'s groups."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def _mesh_for(axis: str):
    mesh = _ACTIVE.get()
    if mesh is None or axis not in mesh.groups:
        raise NameError(f"unbound axis name {axis!r}: no active mesh names it "
                        "(run the code under utils.axes.active(mesh))")
    return mesh


def axis_index(axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    mesh = _mesh_for(axis)
    return mesh.dp if axis == "dp" else mesh.sp


def axis_size(axis: str) -> int:
    """The number of ranks along ``axis``."""
    return _mesh_for(axis).shape[axis]


def sp_group():
    """The active mesh's sp group when it spans more than one rank, else
    None (``utils.lanes.any_lane`` agrees its predicates over it)."""
    mesh = _ACTIVE.get()
    return mesh.groups["sp"] if mesh is not None and mesh.n_sp > 1 else None


@torch.library.custom_op("rgc_slam::psum", mutates_args=())
def _psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    if axis_size(axis) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_mesh_for(axis).groups[axis])
    return out


@_psum.register_fake
def _psum_fake(x, axis):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _psum_vmap(info, in_dims, x, axis):
    # x arrives with its lanes as an ordinary dimension: one collective
    # reduces every lane, and the result keeps the lanes where they were
    return _psum(x, axis), in_dims[0]


_psum.register_vmap(_psum_vmap)


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of the named axis (``jax.lax.psum``).
    Bools and integers are summed as int32, as the JAX package's gather
    does."""
    if x.dtype == torch.bool or not x.is_floating_point():
        x = x.to(torch.int32)
    return _psum(x, axis)
