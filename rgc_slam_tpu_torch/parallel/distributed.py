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
* ``run_ranks(fn, world, ...)`` runs ``fn`` on ``world`` new processes
  joined by a gloo process group and returns their results, raising the
  first failure instead of hanging.  The ranks never run the calling
  script, so ``fn`` lives in an importable module.

Code run under ``utils.axes.active(mesh)`` resolves the axis names
``"dp"`` and ``"sp"`` to the mesh's groups (``psum``, ``axis_index``,
``axis_size``).  Gloo's all-reduce takes CUDA tensors (it stages them
through the host), so ranks that share one card can run the sharded step
on it.
"""
from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
import types
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

# A rank's interpreter: the caller's sys.path (argv[3:]), then _rank_child.
_RANK_BOOT = ("import sys; sys.path[:] = sys.argv[3:]; "
              "from rgc_slam_tpu_torch.parallel.distributed import _rank_child; "
              "_rank_child(sys.argv[1], int(sys.argv[2]))")


def _main_attr(module: str, qualname: str):
    """``qualname`` of the module ``module``, imported by name."""
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


class _RankPickler(pickle.Pickler):
    """Pickles a rank's function and arguments.  A function or class
    defined in ``__main__`` pickles by the module's own name when the
    program ran as ``python -m <module>``, and is refused otherwise: a
    rank never runs the calling script, so it could not load it."""

    def reducer_override(self, obj):
        if (not isinstance(obj, (type, types.FunctionType))
                or getattr(obj, "__module__", None) != "__main__"):
            return NotImplemented
        module = getattr(sys.modules["__main__"].__spec__, "name", None)
        if module is None or module.endswith(".__main__"):
            raise ValueError(
                f"run_ranks: {obj.__qualname__} is defined in __main__, the script that "
                f"called run_ranks.  A rank is a fresh interpreter that never runs that "
                f"script, whether or not its work sits under `if __name__ == \"__main__\":`, "
                f"so it cannot load {obj.__qualname__}: define it in an importable module.")
        return _main_attr, (module, obj.__qualname__)


def _write_result(path: str, result):
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)


def _rank_child(payload: str, rank: int):
    """A rank's process: load ``fn`` and its arguments, join the gloo
    group, run ``fn(rank, world, device, *args)`` and leave ``(ok,
    payload)`` in ``rank<r>.result`` beside ``payload``."""
    report = os.path.join(os.path.dirname(payload), f"rank{rank}.result")
    try:
        with open(payload, "rb") as f:
            fn, world, device, init, timeout_s, args = pickle.load(f)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, torch.device(device), *args)
        finally:
            dist.destroy_process_group()
        _write_result(report, (True, out))
    except BaseException as exc:          # reported to the parent, which raises it
        tb = traceback.format_exc()
        try:
            blob = pickle.dumps(exc)
        except Exception:
            blob = None
        _write_result(report, (False, (blob, tb)))
        raise


def run_ranks(fn: Callable, world: int, device, args: Sequence[Any] = (),
              timeout_s: float = 300.0):
    """Run ``fn(rank, world, device, *args)`` on ``world`` new processes
    joined by one gloo process group, and return the ranks' results in rank
    order.  ``device`` (a ``torch.device`` or its name, passed on as a
    ``torch.device``) is where the ranks put their tensors: every rank may
    use the same card.

    Each rank is a fresh interpreter on the caller's ``sys.path`` that
    imports ``fn``'s module and the modules of ``args``' objects, and never
    runs the calling script: a script needs no ``if __name__ ==
    "__main__":`` guard for the ranks' sake, and its top-level work runs
    once, in the caller.  (``multiprocessing``'s spawn would re-run an
    unguarded script in every rank before the rank started.)  So ``fn``
    and ``args`` must pickle from importable modules (keep JAX out of
    them).  A program run as ``python -m <module>`` may pass its own
    functions: a rank imports that module by name, as any user of it does
    (its ``__main__`` block does not run).  Anything else defined in
    ``__main__`` makes this raise ``ValueError`` before any rank starts,
    the message naming it and the guard.  The results pickle back.

    The rendezvous is a file in a fresh temporary directory, so concurrent
    callers never share a port.  The collectives time out after
    ``timeout_s``, and so does the whole call: a rank that raises makes
    this raise the same exception (its traceback attached as a note), and
    a rank that exits without a result, or a call past ``timeout_s``, makes
    it raise ``RuntimeError``; every rank is stopped first."""
    with tempfile.TemporaryDirectory(prefix="rgc_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        payload = os.path.join(tmp, "payload.pkl")
        with open(payload, "wb") as f:
            _RankPickler(f).dump((fn, world, str(device), init, timeout_s, tuple(args)))
        procs = [subprocess.Popen([sys.executable, "-c", _RANK_BOOT, payload, str(r), *sys.path])
                 for r in range(world)]
        got: dict = {}
        failure = None
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world and failure is None:
                for r, p in enumerate(procs):
                    if r in got:
                        continue
                    code = p.poll()          # before the file: a rank writes, then exits
                    report = os.path.join(tmp, f"rank{r}.result")
                    if os.path.exists(report):
                        with open(report, "rb") as f:
                            ok, out = pickle.load(f)
                        if ok:
                            got[r] = out
                            continue
                        blob, tb = out
                        failure = pickle.loads(blob) if blob is not None else RuntimeError(tb)
                        failure.add_note(f"raised on rank {r} of {world}:\n{tb}")
                    elif code is not None:
                        failure = RuntimeError(f"rank {r} exited with code {code} and no result")
                    if failure is not None:
                        break
                if failure is None and len(got) < world:
                    if time.monotonic() > deadline:
                        failure = RuntimeError(f"run_ranks: no result from ranks "
                                               f"{sorted(set(range(world)) - set(got))} "
                                               f"within {timeout_s} s")
                    else:
                        time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None and (failure is not None or len(got) < world):
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=10)
        if failure is not None:
            raise failure
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} exited with codes {[procs[r].returncode for r in bad]}")
        return [got[r] for r in range(world)]
