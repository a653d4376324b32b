"""Entry points: the single-device step check and the multi-device dry run,
the port of ``__graft_entry__.py``.

    python -m rgc_slam_tpu_torch.tools.graft_entry [n] [--device cuda|cpu]

prints ``entry OK`` once ``entry()``'s step has run, then ``dryrun_multichip
OK`` once ``dryrun_multichip(n)`` has passed (``n`` defaults to the number
of cards, 1 on the CPU).

* ``entry(device)`` returns ``(fn, args)``: ``slam_step`` at ENTRY_CONFIG
  (``__graft_entry__.py:16-31``, compact capacities, the full config's code
  paths) compiled (``utils.graph.CompiledStep``, the counterpart of the JAX
  entry's ``jax.jit``) and its initial state and first scan on ``device``.
  JAX's "compile" is one call of ``fn(*args)`` and a synchronize: on the
  card that call runs the step once and captures its CUDA graph.
* ``dryrun_multichip(n, n_steps)`` (``__graft_entry__.py:56-145``) runs
  ``fleet.make_distributed_step`` over an n-rank ("dp", "sp") mesh, dp = n/2
  x sp = 2 for even n (else dp = n x sp = 1), one robot a dp row, over
  ``n_steps`` scans of a short drive, and asserts that the dp-summed mean
  fitness is finite, every trajectory is finite and the sharded trajectory
  lies within 5e-3 m of the same fleet stepped by ``fleet.fleet_step`` in
  this process (compiled).  The ranks are processes (``parallel.distributed.
  run_ranks``, gloo): with at least n cards rank r takes ``cuda:r``, with
  fewer every rank shares ``cuda:0``.  JAX's XLA-flag and virtual-device
  setup (``:72-91``) has no counterpart.

The program runs on ``cuda`` unless given ``--device cpu`` and raises
without CUDA.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time
from collections import Counter

import numpy as np
import torch

from ..config import SlamConfig
from ..io import synthetic
from ..io.convert import cloud_from_scan_dict, imu_from_interval
from ..models.slam import SlamState, slam_step
from ..ops.cuda import knn as knn_cuda
from ..ops.cuda import map_lm as map_lm_cuda
from ..parallel import fleet
from ..parallel.distributed import run_ranks
from ..types import ImuBatch, PointCloud, tree_items, tree_map
from ..utils import graph
from . import common

# compact capacities: fast compile, same code paths as the full config
ENTRY_CONFIG = SlamConfig(
    max_points=4096,
    max_points_per_ring=256,
    max_source_points=1024,
    max_voxels=2048,
    max_keyframes=64,
    max_kf_corner=128,
    max_kf_surf=512,
    max_map_points=4096,
    max_loops=8,
    max_loop_submap_points=2048,
    vgicp_max_iterations=10,
    max_sharp_total=512,
    max_flat_total=1024,
    max_inten_total=512,
)
DRIVE = dict(n_azimuth=120, seed=0, extent=15.0, radius=6.0, noise=0.005, closes_loop=False,
             speed=1.5)
GATE_M = 5e-3        # sp point-sharding reorders float32 sums (__graft_entry__.py:139-145)
RANK_TIMEOUT_S = 600


def _example_inputs(cfg: SlamConfig, n_azimuth: int = 120, device="cuda"):
    seq = synthetic.generate_sequence(n_scans=3, **dict(DRIVE, n_azimuth=n_azimuth))
    cloud = cloud_from_scan_dict(seq["scans"][0], cfg, device)
    t_imu, acc, gyr = seq["imu"][0]
    imu = imu_from_interval(t_imu, acc, gyr, cfg.max_imu, device)
    stamp = torch.tensor(seq["stamps"][0], dtype=torch.float32, device=device)
    return cloud, imu, stamp


def entry(device="cuda"):
    """(fn, example_args) for a single-device check of the flagship
    scan->pose step (features -> odometry -> mapping)."""
    dev = common.device(device)
    cfg = ENTRY_CONFIG
    fn = graph.CompiledStep(functools.partial(slam_step, cfg=cfg))
    state = SlamState.init(cfg, dev)
    cloud, imu, stamp = _example_inputs(cfg, device=dev)
    return fn, (state, cloud, imu, stamp)


def mesh_shape(n_devices: int):
    """(n_dp, n_sp): dp = n/2 x sp = 2 for even n >= 2, else dp = n x sp = 1."""
    if n_devices >= 2 and n_devices % 2 == 0:
        return n_devices // 2, 2
    return n_devices, 1


def drive_scans(cfg: SlamConfig, n_steps: int):
    """``n_steps`` scans of a short drive through one world, as numpy
    (cloud fields, imu fields, stamp)."""
    seq = synthetic.generate_sequence(n_scans=n_steps, **DRIVE)
    out = []
    for k in range(min(n_steps, len(seq["scans"]))):
        t_imu, acc, gyr = seq["imu"][k]
        out.append(({n: v.numpy() for n, v in tree_items(cloud_from_scan_dict(seq["scans"][k], cfg,
                                                                                "cpu"))},
                    {n: v.numpy() for n, v in tree_items(imu_from_interval(t_imu, acc, gyr,
                                                                           cfg.max_imu, "cpu"))},
                    float(seq["stamps"][k])))
    return out


def _robots(arrays: dict, cls, n: int, device):
    """``n`` robots' copies of one scan's fields [n, ...] on ``device``."""
    one = cls(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})
    return tree_map(lambda a: a[None].expand(n, *a.shape).clone(), one)


def dryrun_rank(rank, world, device, n_dp, n_sp, scans, cfg):
    """One rank of ``dryrun_multichip`` (run by ``run_ranks``): its dp
    block of one robot on an (n_dp, n_sp) mesh, ``make_distributed_step``
    over ``scans``.  On CUDA the rank takes ``cuda:rank`` when there are
    ``world`` cards, else ``cuda:0``, and loads the kernels' libraries that
    the caller built (a rank never builds one).  Returns the rank's t_map
    per scan [scans, 1, 3], the fleet mean fitness per scan, wall ms per
    scan, its kNN launches by shape and the mapping LM kernel's
    evaluations."""
    if device.type == "cuda":
        device = torch.device("cuda", rank if torch.cuda.device_count() >= world else 0)
        torch.cuda.set_device(device)
        common.require_built(rank)
    else:
        torch.set_num_threads(1)
    mesh = fleet.make_mesh(n_dp, n_sp, device)
    step = fleet.make_distributed_step(mesh, cfg)
    states = fleet.fleet_init(cfg, 1, device)
    knn_cuda.reset_counts()
    map_lm_cuda.reset_counts()
    t_map, mean_fit, walls = [], [], []
    for cloud, imu, stamp in scans:
        clouds, imus = _robots(cloud, PointCloud, 1, device), _robots(imu, ImuBatch, 1, device)
        stamps = torch.tensor([stamp], dtype=torch.float32, device=device)
        common.sync(device)
        t0 = time.perf_counter()
        states, outs, fit = step(states, clouds, imus, stamps)
        common.sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        t_map.append(outs.t_map.cpu().numpy())
        mean_fit.append(float(fit))
    return {"t_map": np.stack(t_map), "mean_fit": mean_fit, "wall_ms": walls,
            "device": str(device), "launches": knn_cuda.launches,
            "launches_by_shape": common.knn_launches(),
            "map_lm_evals": map_lm_cuda.evaluations()}


def dryrun_multichip(n_devices: int, n_steps: int = 8, device="cuda", rank_fn=None) -> dict:
    """Run ``n_steps`` fleet steps over an ``n_devices``-rank ('dp', 'sp')
    mesh AND assert that the sharded trajectory equals the one-process vmap
    trajectory within GATE_M.

    Robots are sharded over dp (one a row); inside each robot the
    registration and mapping are point-sharded over sp with psum'd
    partials, and a psum over dp gives the fleet's mean fitness, so both
    mesh axes carry collectives.  ``rank_fn`` replaces ``dryrun_rank``
    (same signature; tests use it to make a rank diverge).  Returns the
    record: mesh, deviation, the ranks' results and the reference's kNN
    launches.

    The ranks are ``run_ranks`` processes: they never run the calling
    script, so a caller needs no ``if __name__ == "__main__":`` guard for
    their sake, and a ``rank_fn`` must live in an importable module (one
    defined in a script run by path raises ``ValueError`` before any rank
    starts; ``python -m`` programs, this one included, hand over their own
    functions by module name)."""
    dev = common.device(device)
    n_dp, n_sp = mesh_shape(n_devices)
    cfg = ENTRY_CONFIG
    n_robots = max(n_dp, 1)
    scans = drive_scans(cfg, n_steps)
    if dev.type == "cuda":
        common.build_kernels()

    t0 = time.perf_counter()
    ranks = run_ranks(rank_fn or dryrun_rank, n_devices, dev, (n_dp, n_sp, scans, cfg),
                      timeout_s=RANK_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0

    # reference: the SAME fleet program vmapped in this process (no mesh)
    launches_before = Counter(common.knn_launches())
    states = fleet.fleet_init(cfg, n_robots, dev)
    fstep = graph.CompiledStep(functools.partial(fleet.fleet_step, cfg=cfg))
    traj_ref = []
    for cloud, imu, stamp in scans:
        stamps = torch.full((n_robots,), stamp, dtype=torch.float32, device=dev)
        states, outs = fstep(states, _robots(cloud, PointCloud, n_robots, dev),
                             _robots(imu, ImuBatch, n_robots, dev), stamps)
        traj_ref.append(outs.t_map.cpu().numpy())
    traj_ref = np.stack(traj_ref)                                  # [T, B, 3]
    ref_launches = dict(Counter(common.knn_launches()) - launches_before)

    # rank = dp * n_sp + sp holds robot dp; every sp rank of a row the same
    traj_sh = np.concatenate([ranks[d * n_sp]["t_map"] for d in range(n_dp)], axis=1)
    mean_fit = ranks[0]["mean_fit"][-1]
    assert np.isfinite(mean_fit), "fleet summary must be finite"
    assert all(np.isfinite(r["t_map"]).all() for r in ranks) and np.isfinite(traj_ref).all()
    dmax = float(max(np.abs(r["t_map"][:, 0] - traj_ref[:, i // n_sp]).max()
                     for i, r in enumerate(ranks)))
    assert dmax < GATE_M, (
        f"sharded trajectory diverged from single-device vmap by {dmax:.4f} m "
        f"over {len(scans)} steps"
    )
    return {"n_dp": n_dp, "n_sp": n_sp, "steps": len(scans), "dev_m": dmax, "gate_m": GATE_M,
            "mean_fit": mean_fit, "traj_sh": traj_sh, "traj_ref": traj_ref, "ranks": ranks,
            "ranks_s": ranks_s, "ref_launches_by_shape": ref_launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks of the dry run (default: the number of cards, 1 on the CPU)")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    fn, fargs = entry(dev)
    fn(*fargs)
    common.sync(dev)
    print("entry OK", flush=True)
    n = args.n if args.n is not None else (torch.cuda.device_count() if dev.type == "cuda" else 1)
    rec = dryrun_multichip(n, device=dev)
    print(f"dp={rec['n_dp']} x sp={rec['n_sp']}, {rec['steps']} steps: sharded vs one process "
          f"{rec['dev_m']:.3e} m (gate {GATE_M} m); {common.device_line(dev)}", flush=True)
    print("dryrun_multichip OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
