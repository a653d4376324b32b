"""Process meshes over ``torch.distributed``: the port's counterpart of
the JAX package's ``("dp", "sp")`` device mesh and of ``shard_map``'s
device set.

The JAX package shards one program over a named mesh
(``rgc_slam_tpu/parallel/fleet.py:264-323``).  Here every mesh position is
one process (a rank):

* ``Mesh`` holds the ``n_dp x n_sp`` layout, this rank's ``dp`` / ``sp``
  coordinates (rank = dp * n_sp + sp, the JAX mesh's row-major device
  order) and the group of each axis: the ranks that share this rank's
  other coordinate; ``make_mesh`` builds it from the default group;
* ``run_ranks(fn, world, ...)`` runs ``fn`` on ``world`` spawned processes
  joined by a gloo process group and returns their results, raising the
  first failure instead of hanging.

Code run under ``utils.axes.active(mesh)`` resolves the axis names
``"dp"`` and ``"sp"`` to the mesh's groups (``psum``, ``axis_index``,
``axis_size``).  Gloo's all-reduce takes CUDA tensors (it stages them
through the host), so ranks that share one card can run the sharded step
on it.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in an ``n_dp x n_sp`` mesh of ranks."""

    n_dp: int
    n_sp: int
    dp: int                   # this rank's row: its block of robots
    sp: int                   # this rank's column: its block of points
    groups: dict              # axis name -> process group of this rank's line
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"dp": self.n_dp, "sp": self.n_sp}


def make_mesh(n_dp: int, n_sp: int, device) -> Mesh:
    """Split the initialized default process group (``n_dp * n_sp`` ranks)
    into the mesh's dp and sp groups, tensors on ``device``.  Every rank
    must call it, in the same order as its other group creations
    (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_dp * n_sp:
        raise ValueError(f"mesh {n_dp} x {n_sp} needs {n_dp * n_sp} ranks, the group has {world}")
    dp, sp = divmod(rank, n_sp)
    groups = {}
    for d in range(n_dp):               # the sp line of row d
        g = dist.new_group([d * n_sp + s for s in range(n_sp)])
        if d == dp:
            groups["sp"] = g
    for s in range(n_sp):               # the dp line of column s
        g = dist.new_group([d * n_sp + s for d in range(n_dp)])
        if s == sp:
            groups["dp"] = g
    return Mesh(n_dp=n_dp, n_sp=n_sp, dp=dp, sp=sp, groups=groups, device=torch.device(device))


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, device: str, init: str, timeout_s: float, args,
               results):
    """A spawned rank: join the gloo group, run ``fn(rank, world, device,
    *args)`` and report ``(rank, ok, payload)``."""
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, torch.device(device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException as exc:          # reported to the parent, which raises it
        tb = traceback.format_exc()
        try:
            blob = pickle.dumps(exc)
        except Exception:
            blob = None
        results.put((rank, False, (blob, tb)))
        raise


def run_ranks(fn: Callable, world: int, device, args: Sequence[Any] = (),
              timeout_s: float = 300.0):
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned processes
    joined by one gloo process group, and return the ranks' results in rank
    order.  ``device`` (a ``torch.device`` or its name, passed on as a
    ``torch.device``) is where the ranks put their tensors: every rank may
    use the same card.

    ``fn`` and ``args`` must pickle (a module-level function; the child
    imports its module afresh, so keep JAX out of that module).  The
    rendezvous is a file in a fresh temporary directory, so concurrent
    callers never share a port.  The collectives time out after
    ``timeout_s``, and so does the whole call: a rank that raises makes
    this raise the same exception (its traceback attached as a note), and
    a rank that exits without a result, or a call past ``timeout_s``, makes
    it raise ``RuntimeError``; every child is stopped first."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="rgc_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, str(device), init, timeout_s,
                                                      tuple(args), results), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict = {}
        failure = None
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world and failure is None:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive() and p.exitcode not in (None, 0)]
                    if dead:
                        failure = RuntimeError(f"rank {dead[0]} exited with code "
                                               f"{procs[dead[0]].exitcode} and no result")
                    elif time.monotonic() > deadline:
                        failure = RuntimeError(f"run_ranks: no result from ranks "
                                               f"{sorted(set(range(world)) - set(got))} "
                                               f"within {timeout_s} s")
                    continue
                if ok:
                    got[rank] = payload
                    continue
                blob, tb = payload
                exc = pickle.loads(blob) if blob is not None else RuntimeError(tb)
                exc.add_note(f"raised on rank {rank} of {world}:\n{tb}")
                failure = exc
        finally:
            for p in procs:
                if p.is_alive() and (failure is not None or len(got) < world):
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        if failure is not None:
            raise failure
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} exited with codes {[procs[r].exitcode for r in bad]}")
        return [got[r] for r in range(world)]
