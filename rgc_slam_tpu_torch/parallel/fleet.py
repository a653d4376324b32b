"""Multi-robot fleet SLAM on one device: the port of the single-device part
of ``rgc_slam_tpu/parallel/fleet.py``.

One call of ``fleet_step`` advances B independent robots, and each
operation of the step is launched once for the whole batch: the step is
``torch.func.vmap`` of the port's own ``slam_step``, as the JAX fleet is
``jax.vmap`` of its ``slam_step``.  Under vmap every state leaf carries a
leading robot axis, and

* each kNN call of the step is one launch of the Hopper kernel for all
  lanes (``ops/knn``'s vmap rule folds the lanes into the kernel's batch);
* the step's host-read early exits and branches keep ``jax.vmap``'s
  semantics (``utils/lanes.any_lane``): a loop runs while any lane runs and
  a finished lane keeps its carry, a branch runs when any lane needs it and
  each lane keeps its own branch's result; so robot b computes what its
  one-robot run computes;
* every operation must have a batching rule: the fleet runs under
  ``utils.lanes.strict_vmap``, where one without raises instead of running
  once per lane.

The JAX module's ``lax.cond``s at top level (not under vmap) become one
host read of a predicate reduced over the lanes, except in
``fleet_step_compacting``, which reads nothing on the host so that it can be
captured into one CUDA graph (``utils/graph``).

The dp x sp mesh (``make_mesh``, ``_sp_plan``, ``make_distributed_step``)
runs over ``torch.distributed`` ranks (``parallel/distributed``): each rank
holds its dp block of robots, every sp rank of a dp row the same robots,
and the step's registration, mapping and (with ``sp_features``) feature
work is point-sharded over the row's sp ranks.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.func import vmap

from ..config import SlamConfig
from ..models.loop import LoopState, loop_closure_step
from ..models.mapping import COMPACT_MARGIN, compact_keyframe_store, worst_cadence_gap
from ..models.slam import SlamState, slam_step
from ..types import ImuBatch, PointCloud, tree_map, tree_where
from ..utils import axes
from ..utils.lanes import strict_vmap
from . import distributed
from .distributed import make_mesh  # noqa: F401  (the JAX module's name for it)


def _lanes(one, n_robots: int):
    """``n_robots`` real copies of a state: a stacked expand would let every
    lane alias one storage."""
    return tree_map(lambda a: a.expand(n_robots, *a.shape).clone(), one)


def fleet_init(cfg: SlamConfig, n_robots: int, device="cuda") -> SlamState:
    """Batched initial state [B, ...] for a fleet of independent robots."""
    return _lanes(SlamState.init(cfg, device), n_robots)


def fleet_step(states: SlamState, clouds: PointCloud, imus: ImuBatch,
               stamps: torch.Tensor, cfg: SlamConfig):
    """vmapped slam_step over the robot axis (single device)."""
    with strict_vmap():
        return vmap(functools.partial(slam_step, cfg=cfg))(states, clouds, imus, stamps)


def compact_fleet(states: SlamState) -> SlamState:
    """Keyframe-store compaction for fleets, which run with
    ``cfg.inline_compaction=False`` (see the JAX module).  Each robot
    compacts only if its store is within COMPACT_MARGIN of capacity
    (where-select per leaf, so under-capacity robots keep their state
    bit-exact)."""

    def one(ms):
        need = ms.kf_count >= ms.kf_q.shape[0] - COMPACT_MARGIN
        return tree_where(need, compact_keyframe_store(ms)[0], ms)

    with strict_vmap():
        return states.replace(mapping=vmap(one)(states.mapping))


def _near_capacity(kf_count: torch.Tensor, K: int) -> torch.Tensor:
    """Fleet-compaction predicate: some robot is within COMPACT_MARGIN of
    its capacity ``K`` (a 0-dim bool on the states' device)."""
    return (kf_count >= K - COMPACT_MARGIN).any()


def compact_fleet_if_needed(states: SlamState) -> SlamState:
    """Host-gated compaction: one host read of ``_near_capacity``, and
    ``compact_fleet`` only when some robot is within COMPACT_MARGIN of
    capacity."""
    K = states.mapping.kf_q.shape[-2]          # [..., K, 4]
    if bool(_near_capacity(states.mapping.kf_count, K)):
        return compact_fleet(states)
    return states


def fleet_step_compacting(states: SlamState, clouds: PointCloud, imus: ImuBatch,
                          stamps: torch.Tensor, cfg: SlamConfig):
    """fleet_step, then compaction in the same step, with no host read:
    ``compact_fleet`` runs every step and its per-lane where-select keeps
    each robot below the margin bit-exact, so a robot is compacted the very
    scan it crosses the margin, as under the JAX module's top-level
    ``lax.cond`` (whose other branch, no robot near capacity, leaves every
    robot as it is).  Fleets running loop closure rely on
    ``fleet_loop_step``'s loop-aware compaction instead."""
    states, outs = fleet_step(states, clouds, imus, stamps, cfg)
    return compact_fleet(states), outs


def fleet_loop_init(cfg: SlamConfig, n_robots: int, device="cuda") -> LoopState:
    """Batched LoopState [B, ...] for fleet loop closure."""
    return _lanes(LoopState.init(cfg, device), n_robots)


def fleet_loop_step(states: SlamState, loop_states: LoopState, cfg: SlamConfig):
    """vmapped loop_closure_step (with its loop-aware keyframe compaction,
    so fleets running loops must not mix in ``compact_fleet``).  Returns
    (states, loop_states, LoopInfo with a leading robot axis)."""
    with strict_vmap():
        return vmap(functools.partial(loop_closure_step, cfg=cfg))(states, loop_states)


def fleet_loop_fused_step(states: SlamState, loop_states: LoopState, counter: torch.Tensor,
                          clouds: PointCloud, imus: ImuBatch, stamps: torch.Tensor,
                          cfg: SlamConfig):
    """fleet_step + cadence-gated loop closure: the loop step runs after the
    scan on which ``counter`` (a 0-dim int tensor, the scans before this
    step) crosses a multiple of ``cfg.loop_cadence``.  Returns (states,
    loop_states, counter + 1, outputs)."""
    states, outs = fleet_step(states, clouds, imus, stamps, cfg)
    new_counter = counter + 1
    if bool(torch.remainder(new_counter, cfg.loop_cadence) == 0):
        states, loop_states, _ = fleet_loop_step(states, loop_states, cfg)
    return states, loop_states, new_counter, outs


def _needs_exact_cadence(cfg: SlamConfig, chunk: int) -> bool:
    """Whether ``make_fleet_chunk_step`` must fire the loop step per scan:
    when ``chunk`` exceeds the cadence, or when one firing at chunk end
    leaves a worst gap between loop-aware compactions above
    ``mapping.COMPACT_MARGIN`` (see the JAX module)."""
    return chunk > cfg.loop_cadence or (
        worst_cadence_gap(cfg.loop_cadence, chunk) > COMPACT_MARGIN
    )


def make_fleet_chunk_step(cfg: SlamConfig, chunk: int):
    """A callable advancing ``chunk`` scans per call with loop closure
    folded in.  It takes ``(states, loop_states, counter, *flat)``, where
    flat interleaves chunk (clouds, imus, stamps) triples, and returns
    ``(states, loop_states, counter, [outs] * chunk)``.

    The firing semantics are the JAX module's: when ``chunk <=
    cfg.loop_cadence`` and the worst gap fits ``COMPACT_MARGIN``, the loop
    step runs once at chunk end if a cadence boundary fell inside the chunk
    (identical to per-scan firing when ``cfg.loop_cadence % chunk == 0``);
    otherwise it runs per scan at the exact cadence
    (``fleet_loop_fused_step``)."""
    exact_cadence = _needs_exact_cadence(cfg, chunk)

    def chunk_step(states, loop_states, counter, *flat):
        outs = []
        if exact_cadence:
            for i in range(chunk):
                states, loop_states, counter, out = fleet_loop_fused_step(
                    states, loop_states, counter, *flat[3 * i:3 * i + 3], cfg)
                outs.append(out)
            return states, loop_states, counter, outs
        for i in range(chunk):
            states, out = fleet_step(states, *flat[3 * i:3 * i + 3], cfg)
            outs.append(out)
        new_counter = counter + chunk
        if bool((new_counter // cfg.loop_cadence) > (counter // cfg.loop_cadence)):
            states, loop_states, _ = fleet_loop_step(states, loop_states, cfg)
        return states, loop_states, new_counter, outs

    return chunk_step


def _sp_plan(cfg: SlamConfig, n_sp: int) -> SlamConfig:
    """The sp-axis sharding plan for an n_sp-wide mesh.

    Block slicing needs the point capacities divisible by n_sp; otherwise
    the registration falls back to stride masking (right, less saving).
    The two fallbacks are independent: an indivisible max_points turns off
    only the sp feature front-end (sp_features=False), never the
    registration / mapping block sharding its own capacities allow."""
    divisible = all(c % n_sp == 0
                    for c in (cfg.max_source_points, cfg.max_kf_corner, cfg.max_kf_surf))
    sp_features = cfg.sp_features and divisible and cfg.max_points % n_sp == 0
    return dataclasses.replace(cfg, psum_axis="sp", sp_shards=n_sp if divisible else 1,
                               sp_features=sp_features)


def make_distributed_step(mesh: distributed.Mesh, cfg: SlamConfig):
    """The fleet step over a ("dp", "sp") mesh of ranks.

    Each rank passes its dp block of robots (every sp rank of a dp row the
    same ones); each robot's registration, mapping association and solves
    (and its feature front-end with ``sp_features``) are point-sharded over
    sp, summed by psum.  Returns a function (states, clouds, imus, stamps)
    -> (states, outputs, fleet_mean_fitness), the mean over every robot of
    the mesh (a psum over "dp")."""
    sp_cfg = _sp_plan(cfg, mesh.n_sp)
    step_one = functools.partial(slam_step, cfg=sp_cfg)

    def step(states, clouds, imus, stamps):
        with axes.active(mesh), strict_vmap():
            new_states, outs = vmap(step_one)(states, clouds, imus, stamps)
            total = axes.psum(outs.fitness.sum(), "dp")
            count = axes.psum(torch.tensor(float(outs.fitness.shape[0]),
                                                  device=mesh.device), "dp")
        return new_states, outs, total / count

    return step
