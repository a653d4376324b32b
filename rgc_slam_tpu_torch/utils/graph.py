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

A capture can hold conditional IF nodes (``ops/cuda/graph_if``): the VGICP
LM captures its bodies under them (``ops/registration.lm_drive``), so a
replay skips the iterations a scan does not need; the warm-up runs every
body.  A graph that holds them is instantiated once, as every graph here
is (CUDA refuses a second instantiation).

The step must not read the device from the host and must not build tensors
from Python values after its first run (``tests/test_torch_capture.py``
holds ``models.slam.slam_step`` and ``parallel.fleet.fleet_step`` to that on
the CPU).  The hand-written kernels' wrappers count the calls they make;
a replay launches the graph's kernels without them.  Each captured
structure keeps the calls its capture recorded, by kernel
(``_Graph.counts``, from ``ops/cuda.capture_counts``, which knows every
counting wrapper), and a replay adds them to the wrappers' replayed counts
(``ops/cuda.add_replayed``); what a replay ran is also read from the
device's trace (``torch.profiler``, ``chip_smoke.py``), which must agree.

Tracing: a capture made inside a call of ``utils.profiling.tracer``
(``SlamSystem``'s, unless it was built with ``trace=False``) holds a timing
event at each ``mark(name)`` the step passes (an event-record node,
recorded at every replay), one first (``begin``) and one after the state's
copy (``state_copy``); a capture made outside one holds no events.  A
replay inside a call also records four events on the stream around it,
outside the graph, and takes the host spans ``copy_in``, ``launch`` and
``clone``; the call reads the events' times when it returns
(``_Graph.read``), after its pose read, so the host waits for nothing
more.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter
from typing import Callable, List, Optional

import torch
import torch.utils._pytree as pytree

from ..ops import cuda as cuda_ops
from . import profiling

_disabled = 0
_marking = None       # (marks, new_event) while a traced capture runs


def _timing_event():
    # an event-record node in a captured graph, timed at every replay
    return torch.cuda.Event(enable_timing=True, external=True)


@contextlib.contextmanager
def marking(new_event: Callable = _timing_event):
    """Within the block ``mark(name)`` records ``new_event()`` on the
    current stream and appends ``(name, event)`` to the list it yields."""
    global _marking
    prev, marks = _marking, []
    _marking = marks, new_event
    try:
        yield marks
    finally:
        _marking = prev


def mark(name: str) -> None:
    """The end of the step's stage ``name``: a timing event inside a traced
    capture (``marking``), nothing anywhere else (eager, the CPU, the
    warm-up, ``disabled()``, tracing off); it reads and makes no tensor."""
    if _marking is not None:
        marks, new_event = _marking
        event = new_event()
        event.record()
        marks.append((name, event))


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
    the inputs'), its graph, its outputs' buffers, and the hand-written
    kernels' calls its capture recorded ({kernel: Counter}), which every
    replay launches."""

    def __init__(self, state_spec, flat_spec, metas, static: List[torch.Tensor], n_state: int):
        self.state_spec, self.flat_spec, self.metas = state_spec, flat_spec, metas
        self.static, self.n_state = static, n_state
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out_spec = None
        self.outs: List[torch.Tensor] = []
        self.counts: dict = {}
        self.capture_s = self.instantiate_s = 0.0
        self.marks: list = []         # (name, event) in the graph, in order
        self.events: list = []        # before / after the copy-in, after replay, after clones

    def read(self, rec) -> None:
        """Add the last replay's device ms to the tracer's record ``rec``:
        each stage between consecutive marks, and the replay's parts."""
        stages, dev = rec.stages, rec.device
        prev = self.marks[0][1]
        for name, event in self.marks[1:]:
            stages[name] = stages.get(name, 0.0) + prev.elapsed_time(event)
            prev = event
        first, last = self.marks[0][1], self.marks[-1][1]
        before, copied, replayed, cloned = self.events
        for name, ms in (("graph", first.elapsed_time(last)),
                         ("copy_in", before.elapsed_time(copied)),
                         ("launch", copied.elapsed_time(first)),
                         ("clone", replayed.elapsed_time(cloned)),
                         ("call", before.elapsed_time(cloned))):
            dev[name] = dev.get(name, 0.0) + ms


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
        traced = profiling.tracer.current is not None
        marked = marking() if traced else contextlib.nullcontext([])
        with cuda_ops.capture_counts() as counted, marked as marks:
            with torch.cuda.graph(graph, stream=side), disabled():
                mark("begin")
                new_state, outs = self.step_fn(state_s, *flat_s)
                new_leaves, new_spec = pytree.tree_flatten(new_state)
                if new_spec != g.state_spec:
                    raise ValueError("compiled step: the step changed the state's structure")
                out_leaves, g.out_spec = pytree.tree_flatten(outs)
                g.outs = _unaliased(out_leaves, static_storages)
                for dst, src in zip(g.static[:g.n_state],
                                    _unaliased(new_leaves, static_storages)):
                    dst.copy_(src)
                mark("state_copy")
        g.marks = list(marks)
        if g.marks:
            g.events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t1 = time.perf_counter()
        graph.instantiate()
        g.instantiate_s, g.capture_s = time.perf_counter() - t1, t1 - t0
        g.graph = graph
        g.counts = {name: Counter(c) for name, c in counted.items()}
        self.graphs.append(g)
        # the warm-up's state is the one the next call starts from
        for dst, src in zip(g.static[:g.n_state], warm):
            dst.copy_(src)
        return (pytree.tree_unflatten(warm, g.state_spec),
                pytree.tree_unflatten(warm_outs, out_spec))

    def _replay(self, g: _Graph, leaves):
        tracer = profiling.tracer
        events = g.events if tracer.current is not None else ()
        if events:
            events[0].record()
        # no tensor a caller holds shares a static buffer's storage: every
        # returned tensor is a clone
        with tracer.span("copy_in"):
            for dst, src in zip(g.static, leaves):
                dst.copy_(src)
        if events:
            events[1].record()
        with tracer.span("launch"):
            g.graph.replay()
        cuda_ops.add_replayed(g.counts)
        if events:
            events[2].record()
        with tracer.span("clone"):
            out = (pytree.tree_unflatten([x.clone() for x in g.static[:g.n_state]], g.state_spec),
                   pytree.tree_unflatten([x.clone() for x in g.outs], g.out_spec))
        if events:
            events[3].record()
            tracer.defer(g.read)
        return out

