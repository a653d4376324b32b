"""Rank bodies that ``chip_smoke.py`` runs through
``parallel.distributed.run_ranks``: a rank never runs the script that
started it, so its function lives in a module.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import SlamConfig
from ..ops.cuda import knn as knn_cuda
from ..ops.cuda import map_lm as map_lm_cuda
from ..parallel import fleet
from ..types import ImuBatch, PointCloud
from .common import require_built, shape_counts


def shard_rank(rank, world, device, scans):
    """Phase 8 on one rank: the kernels' libraries that phase 2 built (a
    rank never builds one: two ranks building into one directory would
    race), a (1, world) mesh on ``device``, ``fleet.make_distributed_step``
    with one robot at ``SlamConfig(loop_closure_enable=False,
    sp_features=True)`` over ``scans``.  Returns the rank's poses, wall ms,
    kNN launches per scan (in total and by shape) and the mapping LM
    kernel's evaluations per scan."""
    require_built(rank)
    torch.cuda.set_device(device)
    cfg = SlamConfig(loop_closure_enable=False, sp_features=True)
    mesh = fleet.make_mesh(1, world, device)
    step = fleet.make_distributed_step(mesh, cfg)
    states = fleet.fleet_init(cfg, 1, device)

    def lane(cls, arrays):
        return cls(**{k: torch.from_numpy(v).to(device)[None] for k, v in arrays.items()})

    knn_cuda.reset_counts()
    map_lm_cuda.reset_counts()
    t_map, walls, launches, shapes, lm_evals = [], [], [], [], []
    for cloud, imu, stamp in scans:
        clouds, imus = lane(PointCloud, cloud), lane(ImuBatch, imu)
        stamps = torch.tensor([stamp], dtype=torch.float32, device=device)
        before, shapes_before = knn_cuda.launches, knn_cuda.launches_by_shape.copy()
        lm_before = map_lm_cuda.evaluations()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, outs, _ = step(states, clouds, imus, stamps)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(knn_cuda.launches - before)
        shapes.append(shape_counts(knn_cuda.launches_by_shape - shapes_before))
        lm_evals.append(map_lm_cuda.evaluations() - lm_before)
        t_map.append(outs.t_map[0].cpu().numpy())
    return {"t_map": np.stack(t_map), "wall_ms": walls, "launches_per_scan": launches,
            "shapes_per_scan": shapes, "launches": knn_cuda.launches,
            "launches_by_shape": shape_counts(knn_cuda.launches_by_shape),
            "map_lm_per_scan": lm_evals}
