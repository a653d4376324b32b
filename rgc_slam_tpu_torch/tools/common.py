"""What the evaluation programs of ``rgc_slam_tpu_torch.tools`` share: the
device they run on, one synchronize, and the line that names the card.

Every tool runs on ``cuda`` unless given ``--device cpu``; without CUDA the
default raises, and nothing falls back to the CPU.
"""
from __future__ import annotations

import os
import subprocess

import torch


def add_device_arg(ap):
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which raises without CUDA; "
                         "pass cpu to run on the CPU)")


def device(name: str) -> torch.device:
    """``name`` as a torch device; a CUDA device on a machine without CUDA
    raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available; pass --device cpu "
                           "to run on the CPU")
    return dev


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[dev.index or 0]


def reset_knn():
    """Set the kNN kernel's launch counts to zero."""
    from ..ops.cuda import knn as knn_cuda
    knn_cuda.reset_counts()


def shape_counts(counter) -> dict:
    """kNN launch counts keyed by (lanes, queries, points, k), named as
    ``chip_smoke.py`` names them ("QxN k=K", "BxQxN k=K" for B lanes)."""
    return {(f"{nq}x{n} k={k}" if b == 1 else f"{b}x{nq}x{n} k={k}"): c
            for (b, nq, n, k), c in sorted(counter.items())}


def knn_launches() -> dict:
    """The kNN kernel's launches since ``reset_knn`` by shape
    (``shape_counts``); empty off the card, where no kernel launches."""
    from ..ops.cuda import knn as knn_cuda
    return shape_counts(knn_cuda.launches_by_shape)


def _kernel_modules():
    from ..ops.cuda import knn as knn_cuda
    from ..ops.cuda import map_lm as map_lm_cuda
    return knn_cuda, map_lm_cuda


def build_kernels():
    """Build the port's hand-written kernels (kNN, the mapping LM's) where
    they are older than their sources, before ranks start."""
    for mod in _kernel_modules():
        mod.build()


def require_built(rank: int):
    """A rank's check that its caller built the kernels' libraries: a rank
    never builds one (ranks building into one directory would race)."""
    for mod in _kernel_modules():
        if not (os.path.exists(mod.LIBRARY)
                and os.path.getmtime(mod.LIBRARY) >= os.path.getmtime(mod.SOURCE)):
            raise RuntimeError(f"rank {rank}: no up-to-date {mod.LIBRARY}")
