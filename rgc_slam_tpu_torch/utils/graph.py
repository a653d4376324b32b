"""The compiled step: the port's counterpart of ``jax.jit`` for a step
function.

``CompiledStep(step_fn)`` turns ``step_fn(state, *flat) -> (state, outs)``
(``state`` and ``flat`` pytrees of tensors) into a callable with the same
signature that runs the whole step as one captured CUDA graph:

* it keeps static device buffers for the state and the inputs, one set per
  structure, shapes, dtypes and device of ``(state, *flat)`` (a new
  structure captures a new graph, as ``jax.jit`` retraces);
* its first call for a structure runs ``step_fn`` eagerly on a side stream
  (the warm-up: it builds the kNN library and fills ``utils.math3d.const``'s
  cache before any capture), and that run's results are the call's
  results; then it captures one ``torch.cuda.CUDAGraph`` of ``step_fn`` on
  the static buffers, ending with the copy of the new state into the static
  state buffers;
* every later call copies its state and inputs into the static buffers and
  replays the graph.

The state and the outputs are cloned after each replay, so no returned
tensor aliases a buffer that a later replay overwrites (``jax.jit`` returns
fresh arrays; a loop step's state keeps references to the step's, for
one).  A state that a caller passes back is copied into the static buffers
at the next call (a device-to-device copy of a few MB a robot).

On a CPU state (or one whose first leaf is no tensor) the callable calls
``step_fn`` eagerly: that is the device the caller asked for.  On CUDA a failed capture raises; nothing falls back
to the eager step.  Within ``disabled()`` (``jax.disable_jit``'s
counterpart) the callable calls ``step_fn`` eagerly on any device; a
compiled step called inside another's warm-up or capture runs inline, as a
jitted function inside a jitted one does.

The step must not read the device from the host and must not build tensors
from Python values after its first run (``tests/test_torch_capture.py``
holds ``models.slam.slam_step`` and ``parallel.fleet.fleet_step`` to that on
the CPU).  The kNN kernel's wrapper counts the launches it makes; a
replay launches the graph's kernels without it, so its counts see only the
warm-up's.  Each captured structure keeps the kNN calls its capture
recorded (``_Graph.knn``); what a replay ran is read from the device's
trace (``torch.profiler``, ``chip_smoke.py``), which must agree with it.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter
from typing import Callable, List, Optional

import torch
import torch.utils._pytree as pytree

from ..ops.cuda import knn as knn_cuda

_disabled = 0


@contextlib.contextmanager
def disabled():
    """Within the block every compiled step calls its function eagerly."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def _storages(leaves) -> set:
    return {x.untyped_storage().data_ptr() for x in leaves}


def _unaliased(leaves, static_storages: set) -> list:
    """``leaves`` with each one that shares storage with a static buffer
    cloned, so copying them into the static buffers in any order reads no
    buffer that an earlier copy has overwritten."""
    return [x.clone() if x.untyped_storage().data_ptr() in static_storages else x
            for x in leaves]


class _Graph:
    """One captured structure: its static buffers (the state's leaves, then
    the inputs'), its graph, its outputs' buffers, and the kNN calls (by
    shape) its capture recorded, which every replay launches."""

    def __init__(self, state_spec, flat_spec, metas, static: List[torch.Tensor], n_state: int):
        self.state_spec, self.flat_spec, self.metas = state_spec, flat_spec, metas
        self.static, self.n_state = static, n_state
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out_spec = None
        self.outs: List[torch.Tensor] = []
        self.knn: Counter = Counter()
        self.capture_s = self.instantiate_s = 0.0


class CompiledStep:
    """``step_fn`` captured per input structure and replayed (the
    module's docstring).  ``graphs`` holds the captured structures; the
    ``capture_s`` / ``instantiate_s`` of each are the host seconds of its
    capture and of its graph's instantiation."""

    def __init__(self, step_fn: Callable):
        self.step_fn = step_fn
        self.graphs: List[_Graph] = []

    def __call__(self, state, *flat):
        state_leaves, state_spec = pytree.tree_flatten(state)
        flat_leaves, flat_spec = pytree.tree_flatten(flat)
        leaves = state_leaves + flat_leaves
        first = leaves[0] if leaves else None
        if _disabled or not isinstance(first, torch.Tensor) or first.device.type != "cuda":
            return self.step_fn(state, *flat)
        dev = leaves[0].device
        for x in leaves:
            if not isinstance(x, torch.Tensor) or x.device != dev:
                raise ValueError(f"compiled step: every leaf must be a tensor on {dev}")
        metas = tuple((x.shape, x.dtype) for x in leaves)
        for g in self.graphs:
            if g.metas == metas and g.state_spec == state_spec and g.flat_spec == flat_spec:
                return self._replay(g, leaves)
        g = _Graph(state_spec, flat_spec, metas, [x.clone() for x in leaves], len(state_leaves))
        return self._capture(g, dev)

    def _capture(self, g: _Graph, dev):
        static_storages = _storages(g.static)
        state_s = pytree.tree_unflatten(g.static[:g.n_state], g.state_spec)
        flat_s = pytree.tree_unflatten(g.static[g.n_state:], g.flat_spec)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        # the warm-up, whose results are this call's
        with torch.cuda.stream(side), disabled():
            new_state, outs = self.step_fn(state_s, *flat_s)
            warm = _unaliased(pytree.tree_leaves(new_state), static_storages)
            warm_outs, out_spec = pytree.tree_flatten(outs)
            warm_outs = [x.clone() for x in warm_outs]
        main.wait_stream(side)
        for x in warm + warm_outs:
            x.record_stream(main)
        # the capture: the step on the static buffers, then its new state
        # copied into the static state buffers
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with knn_cuda.capture_counts() as counted:
            with torch.cuda.graph(graph, stream=side), disabled():
                new_state, outs = self.step_fn(state_s, *flat_s)
                new_leaves, new_spec = pytree.tree_flatten(new_state)
                if new_spec != g.state_spec:
                    raise ValueError("compiled step: the step changed the state's structure")
                out_leaves, g.out_spec = pytree.tree_flatten(outs)
                g.outs = _unaliased(out_leaves, static_storages)
                for dst, src in zip(g.static[:g.n_state],
                                    _unaliased(new_leaves, static_storages)):
                    dst.copy_(src)
        t1 = time.perf_counter()
        graph.instantiate()
        g.instantiate_s, g.capture_s = time.perf_counter() - t1, t1 - t0
        g.graph, g.knn = graph, Counter(counted)
        self.graphs.append(g)
        # the warm-up's state is the one the next call starts from
        for dst, src in zip(g.static[:g.n_state], warm):
            dst.copy_(src)
        return (pytree.tree_unflatten(warm, g.state_spec),
                pytree.tree_unflatten(warm_outs, out_spec))

    def _replay(self, g: _Graph, leaves):
        # no tensor a caller holds shares a static buffer's storage: every
        # returned tensor is a clone
        for dst, src in zip(g.static, leaves):
            dst.copy_(src)
        g.graph.replay()
        return (pytree.tree_unflatten([x.clone() for x in g.static[:g.n_state]], g.state_spec),
                pytree.tree_unflatten([x.clone() for x in g.outs], g.out_spec))

