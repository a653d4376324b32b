"""A fleet's inputs as bench.py stages them: the port of ``bench.py``'s
``_stage_inputs`` (``bench.py:182-218``) and its ``perturb``.

N_SEEDS distinct synthetic worlds are tiled over B robots, and every
(robot, scan) gets its own point noise on the device, so that a batched
early-exit loop cannot finish all robots in lockstep.  The noise comes from
an explicit ``torch.Generator`` on the inputs' device (the JAX function
folds the scan index into ``PRNGKey(0)``; the draws differ, the law is the
same: 5 mm Gaussian on every valid point).
"""
from __future__ import annotations

import torch

from ..config import SlamConfig
from ..io import synthetic
from ..io.convert import cloud_from_scan_dict, imu_from_interval
from ..types import PointCloud, tree_map, tree_stack

N_SEEDS = 8          # bench.py's RGC_BENCH_SEEDS default


def perturb(cloud: PointCloud, generator: torch.Generator, sigma: float = 0.005) -> PointCloud:
    """``sigma`` x N(0, 1) on every valid point, drawn from ``generator``."""
    noise = sigma * torch.randn(cloud.xyz.shape, generator=generator, dtype=cloud.xyz.dtype,
                                device=cloud.xyz.device)
    return cloud.replace(xyz=cloud.xyz + noise * cloud.mask[..., None])


def tile(a: torch.Tensor, reps: int, B: int) -> torch.Tensor:
    """``jnp.tile(a, (reps, 1, ...))[:B]``: the leading axis repeated."""
    return a.repeat(reps, *(1,) * (a.ndim - 1))[:B]


def _stage_inputs(cfg: SlamConfig, B: int, n_scans: int, generator: torch.Generator, device,
                  n_seeds: int = N_SEEDS):
    """Per-robot distinct inputs on ``device``: ``n_seeds`` worlds tiled
    over B robots, plus independent point noise per (robot, scan) from
    ``generator``.  Returns ([(clouds, imus, stamps)] per scan, the first
    world's sequence)."""
    n_seeds = min(n_seeds, B)
    reps = -(-B // n_seeds)  # ceil
    seqs = [
        synthetic.generate_sequence(
            n_scans=n_scans, n_azimuth=900, seed=1 + s,
            extent=30.0, radius=12.0, noise=0.01, closes_loop=False, speed=2.0,
        )
        for s in range(n_seeds)
    ]
    n_scans = min(len(s["scans"]) for s in seqs)
    inputs = []
    for k in range(n_scans):
        clouds, imus, stamps = [], [], []
        for s in range(n_seeds):
            clouds.append(cloud_from_scan_dict(seqs[s]["scans"][k], cfg, device))
            t_imu, acc, gyr = seqs[s]["imu"][k]
            imus.append(imu_from_interval(t_imu, acc, gyr, cfg.max_imu, device))
            stamps.append(seqs[s]["stamps"][k])
        cloudB = tree_map(lambda a: tile(a, reps, B), tree_stack(clouds))
        imuB = tree_map(lambda a: tile(a, reps, B), tree_stack(imus))
        cloudB = perturb(cloudB, generator)
        stampB = tile(torch.tensor(stamps, dtype=torch.float32, device=device), reps, B)
        inputs.append((cloudB, imuB, stampB))
    return inputs, seqs[0]
