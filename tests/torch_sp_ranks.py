"""Rank bodies of the port's sharded tests (tests/test_torch_features_sp.py,
tests/test_torch_distributed.py, tests/test_torch_run_ranks.py,
tests/test_torch_map_lm.py), run by
``parallel.distributed.run_ranks``.

A rank imports this module afresh, so it imports torch and the
port only, never JAX.  Inputs arrive as numpy arrays and results leave as
numpy arrays.
"""
import numpy as np
import torch

from rgc_slam_tpu_torch.models.slam import SlamState, slam_step
from rgc_slam_tpu_torch.ops import factors as fac
from rgc_slam_tpu_torch.ops import features as F
from rgc_slam_tpu_torch.ops.cuda import map_lm
from rgc_slam_tpu_torch.parallel import fleet
from rgc_slam_tpu_torch.tools import map_lm_bench as problems
from rgc_slam_tpu_torch.types import ImuBatch, PointCloud, tree_items, tree_map
from rgc_slam_tpu_torch.utils import axes


def _cloud(arrays: dict, device) -> PointCloud:
    return PointCloud(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def _imu(arrays: dict, device) -> ImuBatch:
    return ImuBatch(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def _numpy(tree) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tree_items(tree)}


def features_sp(rank, world, device, cases):
    """``extract_features_sp`` on a (1, world) mesh for each (cloud, cfg)
    case: this rank's outputs, or the message of the ValueError it raised."""
    torch.set_num_threads(1)
    mesh = fleet.make_mesh(1, world, device)
    results = []
    with axes.active(mesh):
        for cloud, cfg in cases:
            try:
                results.append(_numpy(F.extract_features_sp(_cloud(cloud, device), cfg)))
            except ValueError as exc:
                results.append(str(exc))
    return results


def slam_sp(rank, world, device, scans, cfg):
    """``slam_step`` under a (1, world) mesh over ``scans`` (cloud, imu,
    stamp): this rank's t_map per scan."""
    torch.set_num_threads(1)
    mesh = fleet.make_mesh(1, world, device)
    state = SlamState.init(cfg, device)
    out_t = []
    with axes.active(mesh):
        for cloud, imu, stamp in scans:
            state, out = slam_step(state, _cloud(cloud, device), _imu(imu, device),
                                   torch.tensor(stamp, dtype=torch.float32, device=device), cfg)
            out_t.append(out.t_map.cpu().numpy())
    return np.stack(out_t)


def distributed_fleet(rank, world, device, scans, cfg, n_dp, n_sp, n_robots):
    """``fleet.make_distributed_step`` on an (n_dp, n_sp) mesh: every robot
    gets the same scans; this rank's block of robots.  Returns (t_map
    [scans, robots of the block, 3], fitness of the last scan,
    fleet_mean_fitness of the last scan)."""
    torch.set_num_threads(1)
    mesh = fleet.make_mesh(n_dp, n_sp, device)
    b = n_robots // n_dp
    step = fleet.make_distributed_step(mesh, cfg)
    states = fleet.fleet_init(cfg, b, device)

    def lanes(tree):
        return tree_map(lambda v: v[None].expand(b, *v.shape).clone(), tree)

    t_maps = []
    for cloud, imu, stamp in scans:
        stamps = torch.full((b,), stamp, dtype=torch.float32, device=device)
        states, outs, mean_fit = step(states, lanes(_cloud(cloud, device)),
                                      lanes(_imu(imu, device)), stamps)
        t_maps.append(outs.t_map.cpu().numpy())
    return np.stack(t_maps), outs.fitness.cpu().numpy(), float(mean_fit)


def psum_of_ranks(rank, world, device):
    """(this rank, the ranks' indices summed over a (1, world) mesh)."""
    torch.set_num_threads(1)
    mesh = fleet.make_mesh(1, world, device)
    with axes.active(mesh):
        return rank, float(axes.psum(torch.tensor(float(rank), device=device), "sp"))


def raises_on_one_rank(rank, world, device):
    """Rank 1 raises; the others wait in a collective that never completes."""
    torch.set_num_threads(1)
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh = fleet.make_mesh(1, world, device)
    with axes.active(mesh):
        return float(axes.psum(torch.ones((), device=device), "sp"))


def sharded_step_modules(rank, world, device, scan, cfg):
    """One sharded ``slam_step`` (sp front-end) on a (1, world) mesh; returns
    its t_map and the modules of JAX, flax and the JAX package this rank
    loaded, by name and by file."""
    import os
    import sys

    t_map = slam_sp(rank, world, device, [scan], cfg)
    jax_pkg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "rgc_slam_tpu") + os.sep
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "rgc_slam_tpu"))
    files = sorted(m for m, mod in list(sys.modules.items())
                   if os.path.abspath(getattr(mod, "__file__", None) or "").startswith(jax_pkg))
    return t_map, loaded, files


def diverging_dryrun_rank(rank, world, device, n_dp, n_sp, scans, cfg):
    """``tools.graft_entry.dryrun_rank`` with the last dp row's scans moved
    0.05 m further along x each scan than the others': that robot drives
    another trajectory, so the dry run must fail its gate."""
    from rgc_slam_tpu_torch.tools import graft_entry

    if rank // n_sp == n_dp - 1:
        moved = []
        for k, (cloud, imu, stamp) in enumerate(scans):
            xyz = cloud["xyz"].copy()
            xyz[..., 0] += 0.05 * k
            moved.append((dict(cloud, xyz=xyz), imu, stamp))
        scans = moved
    return graft_entry.dryrun_rank(rank, world, device, n_dp, n_sp, scans, cfg)


def mapping_lm_sp(rank, world, device, sizes, seed, loss):
    """The mapping LM on this rank's block of each query cloud of a seeded
    problem (``tools/map_lm_bench.problem``), the repeated factors at
    ``rep_scale`` 1/sqrt(world), under a (1, world) mesh: ``ceres_lm`` and
    its linearizer entry (the plain linearizer), both summed over "sp".
    Returns the two tangents."""
    torch.set_num_threads(1)
    mesh = fleet.make_mesh(1, world, device)
    c = problems.problem(sizes, seed)

    def block(v):
        n = v.shape[0] // world
        return v[rank * n:(rank + 1) * n]

    for pts, corr in (("corner", "ec"), ("cornl", "ecl"), ("surf", "pc"), ("surfl", "pcl")):
        c[pts] = block(c[pts])
        c[corr] = type(c[corr])(*(block(f) for f in c[corr]))
    c["rep_scale"] = torch.tensor(world ** -0.5)
    res, cost = problems.functions(loss)
    with axes.active(mesh):
        want = fac.ceres_lm(res, cost, 12, 6, c, psum_axis="sp")
        got = fac.ceres_lm_linearized(map_lm.plain_linearizer(res, cost, c), 12, 6, device,
                                      psum_axis="sp")
    return want.numpy(), got.numpy()
