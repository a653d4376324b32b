"""Host-read predicates that stay right under ``torch.func.vmap``.

The port's single-stream code reads loop and branch predicates on the host
(``bool(pred)``) and skips the work they gate.  The JAX package's fleet is
``jax.vmap`` of the same step, under which a ``lax.while_loop`` with a
batched predicate runs while ANY lane's predicate holds (a finished lane
keeps its carry by a select) and a ``lax.cond`` with a batched predicate
runs both branches and selects per lane.

``any_lane(pred)`` is the one primitive the port needs for that: outside
vmap it is ``pred.any()``; under vmap (nested or not) its rule reduces over
the lanes as well and returns an unbatched scalar, which ``bool`` can read
on the host.  The code pattern is then:

* a loop: ``while bool(any_lane(active)): ...`` with each carried value
  updated by ``torch.where(active, new, old)``;
* a branch: ``if bool(any_lane(need)): x = where(need, branch(x), x)``.

At one stream nothing changes: ``any_lane`` of an unbatched predicate is
the predicate, so the loops stop and the branches are skipped exactly as
before.  ``types.tree_where`` is the per-lane select of a branch's result.

Under a sharded step (``utils.axes.active`` with an sp group of
more than one rank) ``any_lane`` also ORs the predicate over the group's
ranks, one MAX all-reduce, so every rank takes the same branch of every
host-read loop and branch: one rank leaving a loop while another enters
the loop's next collective would hang both.

``strict_vmap`` turns off functorch's per-lane fallback, so that an
operator without a batching rule raises instead of running once per lane.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from .axes import sp_group


@torch.library.custom_op("rgc_slam::any_lane", mutates_args=())
def any_lane(pred: torch.Tensor) -> torch.Tensor:
    """True when ``pred`` holds anywhere: in any element and, under vmap,
    in any lane, and under an active sp group on any of its ranks.  The
    result is a 0-dim bool tensor, never batched."""
    out = pred.any()
    group = sp_group()
    if group is not None:
        flag = out.to(torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        out = flag > 0
    return out


@any_lane.register_fake
def _any_lane_fake(pred):
    return pred.new_empty((), dtype=torch.bool)


def _any_lane_vmap(info, in_dims, pred):
    # ``pred`` arrives with its lanes as an ordinary dimension: reducing the
    # whole tensor reduces over them too.  The call re-enters the op, so an
    # enclosing vmap level reduces its own lanes the same way.
    return any_lane(pred), None


any_lane.register_vmap(_any_lane_vmap)


@contextlib.contextmanager
def strict_vmap():
    """Within the block, an operator that ``torch.func.vmap`` cannot batch
    raises instead of being run lane by lane (the vmap fallback is off),
    so every operation of a vmapped step is one batched operation."""
    was = torch._C._functorch._is_vmap_fallback_enabled()
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(was)
