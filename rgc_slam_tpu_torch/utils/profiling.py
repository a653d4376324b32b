"""Tracing / metrics: the port of ``rgc_slam_tpu/utils/profiling.py``.

The structured upgrade of the reference's TicToc (``tic_toc.h:7-29``):
  * ``TicToc``        — drop-in stopwatch (host wall clock)
  * ``StageTimer``    — named-stage accumulator with p50/p95/max summaries and
    the reference's over-budget warning (>100 ms per scan); a stage given a
    ``device`` synchronizes it before the clock stops, so the time covers
    the device's work and not only its dispatch
  * ``Metrics``       — step-indexed scalar registry dumpable to JSON lines
  * ``trace``         — ``torch.profiler`` over a block, exported as a Chrome
    trace

``StageTimer.summary`` and ``Metrics.dump`` write the same JSON as the JAX
module (``timing.json`` and ``metrics.jsonl`` of the CLI).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch


class TicToc:
    """Wall-clock stopwatch (ref include/rgc_slam/tic_toc.h)."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        """Elapsed milliseconds."""
        return (time.perf_counter() - self._t0) * 1000.0


def synchronize(device) -> None:
    """Wait for the work queued on ``device``: ``torch.cuda.synchronize`` on
    a CUDA device, nothing on the CPU (its ops have run when they return)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    def __init__(self, budget_ms: float = 100.0, sync: bool = True):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.budget_ms = budget_ms
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, device: Optional[torch.device] = None):
        """Time the block; with ``device`` (and ``sync``) the device is
        synchronized before the clock stops."""
        t0 = time.perf_counter()
        yield
        if self.sync and device is not None:
            synchronize(device)
        ms = (time.perf_counter() - t0) * 1000.0
        self.samples[name].append(ms)
        if ms > self.budget_ms:
            # the reference warns when odometry exceeds its 100 ms real-time
            # budget (RGC_odometer.cpp:1360-1361)
            print(f"[rgc-slam-tpu] stage '{name}' over budget: {ms:.1f} ms")

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "mean_ms": float(a.mean()),
                "p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "max_ms": float(a.max()),
            }
        return out


class Metrics:
    """Step-indexed scalar registry with JSONL dump."""

    def __init__(self):
        self.records: List[dict] = []

    def log(self, step: int, **scalars):
        rec = {"step": step}
        for k, v in scalars.items():
            rec[k] = float(v) if np.isscalar(v) or hasattr(v, "item") else v
        self.records.append(rec)

    def dump(self, path: str):
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    def series(self, key: str) -> np.ndarray:
        return np.asarray([r[key] for r in self.records if key in r])


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA when a card is
    present); writes ``trace.json`` (Chrome trace format) into ``log_dir``
    and yields the profiler (``key_averages()`` for tables)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
