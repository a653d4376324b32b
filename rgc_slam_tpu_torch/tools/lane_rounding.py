"""Find the first function of the step that rounds identical fleet lanes
differently.

Drives ``parallel.fleet.fleet_step`` (``torch.func.vmap`` of ``slam_step``)
at ``config.FLEET_CONFIG`` with loops off (``chip_smoke.py`` phase 6) and
every lane fed the same scans of one world (900-azimuth sweeps, seed 1),
so that every lane must compute the same bits.  The step's stage functions (features, odometry,
mapping, and the helpers each calls: covariances, eigen solvers, the
voxel hash, the kNN association, the solvers) are wrapped where the
package's modules hold them; a wrapper looks at the physical batched
tensors of its arguments and results (functorch's ``get_unwrapped`` /
``maybe_get_bdim``).  The first call, in completion order (so the
innermost), whose arguments agree across the lanes and whose results do
not is the function that rounds per lane; its most differing result is
printed by name.  Each step also prints how far the lanes' ``t_map`` lie
apart.

    python rgc_slam_tpu_torch/tools/lane_rounding.py [--lanes 128] [--scans 12] [--device cuda]

The last line is a JSON object: that call (function, result name, largest
difference between lanes, the scan) or null, and the spread of ``t_map``
per step.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import json
import sys

import torch

# the functions watched, by module of the package
WATCHED = {
    "ops.features": ["organize", "_pointwise_block", "_ground_solve", "_point_covariances",
                     "_pick_and_pack", "extract_features"],
    "ops.covariance": ["eigh3x3", "scan_covariances", "regularize_covariances"],
    "ops.imu": ["complementary_filter_scan", "preintegrate"],
    "ops.voxelhash": ["voxel_downsample", "build_hash_table", "lookup_slots"],
    "ops.registration": ["find_correspondences", "corr_linearize", "lm_register",
                         "vgicp_fitness"],
    "ops.factors": ["ceres_lm", "degeneracy_projection", "jacobian"],
    "models.odometry": ["deskew_points", "_submap_target", "fusion_solve", "odometry_step"],
    "models.mapping": ["assemble_local_map", "edge_correspondences", "plane_correspondences",
                       "_lstsq_qr", "scan_to_map_solve", "mapping_step"],
}
_INT_OF = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _leaves(x, name):
    """(name, tensor) leaves of nested values: tensors, tuples, dicts and
    the package's Structs."""
    if isinstance(x, torch.Tensor):
        yield name, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{name}.{k}")
    elif isinstance(x, (tuple, list)):
        fields = getattr(x, "_fields", None)
        for i, v in enumerate(x):
            yield from _leaves(v, f"{name}.{fields[i] if fields else i}")
    elif hasattr(x, "__dataclass_fields__"):
        for k in x.__dataclass_fields__:
            yield from _leaves(getattr(x, k), f"{name}.{k}")


def _lane_spread(t: torch.Tensor):
    """Largest |difference| between lane 0 and the other lanes of a
    vmapped tensor (0.0 where they are the same bits), None if unbatched."""
    F = torch._C._functorch
    if not F.is_batchedtensor(t):
        return None
    bdim = 0
    while F.is_batchedtensor(t):
        bdim = F.maybe_get_bdim(t)
        t = F.get_unwrapped(t)
    phys = t.movedim(bdim, 0).contiguous()
    ref = phys[:1].expand_as(phys).contiguous()
    if phys.is_floating_point():
        ints = _INT_OF[phys.element_size()]
        if torch.equal(phys.view(ints), ref.view(ints)):
            return 0.0
        d = (phys.double() - ref.double()).abs()
        return float(torch.nan_to_num(d, nan=float("inf")).max())
    return 0.0 if torch.equal(phys, ref) else float((phys != ref).sum())


class Watch:
    """The wrappers' shared record: the first call that splits the lanes."""

    def __init__(self):
        self.found = None
        self.scan = -1

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def watched(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.found is not None:
                return out
            split = [(n, s) for n, t in _leaves(out, "result") for s in [_lane_spread(t)] if s]
            if not split or any(_lane_spread(t) for _, t in _leaves((args, kwargs), "args")):
                return out                  # the lanes agree, or split upstream
            n, s = max(split, key=lambda e: e[1])
            self.found = {"function": name, "result": n, "max_lane_diff": s, "scan": self.scan,
                          "results_split": [e[0] for e in split][:12]}
            return out
        return watched


def install(watch: Watch):
    """Replace each watched function wherever a module of the package holds
    it; returns a function that puts the originals back."""
    wrapped = {}
    for mod, names in WATCHED.items():
        m = importlib.import_module(f"rgc_slam_tpu_torch.{mod}")
        for n in names:
            fn = getattr(m, n)
            wrapped[id(fn)] = (fn, watch.wrap(f"{mod}.{n}", fn))
    replaced = []
    for mname, m in list(sys.modules.items()):
        if m is None or not mname.startswith("rgc_slam_tpu_torch"):
            continue
        for attr, val in list(vars(m).items()):
            if id(val) in wrapped:
                replaced.append((m, attr, val))
                setattr(m, attr, wrapped[id(val)][1])

    def restore():
        for m, attr, val in replaced:
            setattr(m, attr, val)
    return restore


def run(cfg, lanes: int, scans: int, n_azimuth: int, device) -> dict:
    """``scans`` fleet steps of ``lanes`` identical lanes at ``cfg``, the
    watched functions wrapped for the run: the first split (or None) and
    the spread of ``t_map`` per step."""
    from rgc_slam_tpu_torch.io import synthetic
    from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu_torch.parallel import fleet
    from rgc_slam_tpu_torch.types import tree_map

    dev = torch.device(device)
    watch = Watch()
    restore = install(watch)
    try:
        seq = synthetic.generate_sequence(n_scans=scans + 1, n_azimuth=n_azimuth, extent=30.0,
                                          radius=12.0, noise=0.01, closes_loop=False,
                                          speed=2.0, seed=1)
        states = fleet.fleet_init(cfg, lanes, dev)
        steps = []
        for k in range(scans):
            watch.scan = k
            t_imu, acc, gyr = seq["imu"][k]
            one = (cloud_from_scan_dict(seq["scans"][k], cfg, dev),
                   imu_from_interval(t_imu, acc, gyr, cfg.max_imu, dev),
                   torch.tensor(seq["stamps"][k], dtype=torch.float32, device=dev))
            batch = [tree_map(lambda x: x[None].expand(lanes, *x.shape).contiguous(), x)
                     for x in one]
            states, outs = fleet.fleet_step(states, *batch, cfg)
            spread = float((outs.t_map - outs.t_map[:1]).abs().max())
            steps.append({"scan": k, "t_map_spread_m": spread})
            print(f"scan {k}: lanes' t_map within {spread:.3e} m; first split: "
                  f"{json.dumps(watch.found)}", flush=True)
    finally:
        restore()
    return {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "lanes": lanes, "first_split": watch.found, "steps": steps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--scans", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from rgc_slam_tpu_torch.config import FLEET_CONFIG

    cfg = dataclasses.replace(FLEET_CONFIG, loop_closure_enable=False)
    print(json.dumps(run(cfg, args.lanes, args.scans, 900, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
