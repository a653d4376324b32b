"""Per-stage breakdown of one SLAM step: the port of ``eval_stages.py``.

    python -m rgc_slam_tpu_torch.tools.eval_stages [--reps N] [--device cuda|cpu]
    python -m rgc_slam_tpu_torch.tools.eval_stages --fleet B [--timed N] [--device ...]

``main`` (``eval_stages.py:177-220``) times the stages of one step at
BENCH_CONFIG on a scan a few steps into a 16 x 900 sequence: features,
odometry, the full step, and mapping as the full step less the other two.
``--fleet B`` runs ``fleet_differential`` (``eval_stages.py:48-118``): the
fleet step of B robots at FLEET_CONFIG on bench.py's staged inputs
(``tools/bench_inputs``), with mapping skipped, with the VGICP LM also
capped at one iteration, and the feature stage alone; differences between
the variants estimate each stage's share.  ``fleet_breakdown``
(``eval_stages.py:120-175``) runs its three bodies (features, features +
odometry, the full fleet step) ``iters`` times each in one synchronized
window.

XLA's cost analysis (``eval_stages.py:38-46, 80-88``) has no PyTorch
counterpart, so no row has a FLOP column.  Each row gives instead:

* wall ms: the synchronized host clock around one call, median over
  ``reps`` calls, from runs without the profiler;
* device ms and CUDA kernels per call: ``torch.profiler`` over
  ``prof_reps`` more calls (the profiler inflates the host's time, so the
  wall column never comes from these runs);
* busy: device ms over wall ms, the share of the call the card computes.

Off the card the device columns are "n/a".
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import statistics
import sys
import time

import torch
from torch.func import vmap

from ..config import BENCH_CONFIG, FLEET_CONFIG
from ..io import synthetic
from ..models import odometry as odo_mod
from ..models.slam import SlamState, slam_step
from ..ops import features as F
from ..parallel import fleet
from ..utils.lanes import strict_vmap
from . import common
from .bench_inputs import _stage_inputs
from .eval import scan_inputs

NO_FLOPS = ("no FLOP column: XLA's cost analysis (eval_stages.py:38-46) has no PyTorch "
            "counterpart; device ms and kernel counts come from torch.profiler runs, "
            "wall ms from runs without it")


def _time(fn, args, dev, n=30):
    """Median synchronized wall ms of one call, after one warm-up call."""
    fn(*args)
    common.sync(dev)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        common.sync(dev)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def _device_profile(fn, args, dev, n=2):
    """(device ms, CUDA kernels) per call from ``torch.profiler`` over ``n``
    calls on the card: the summed durations and count of the device's
    kernel events (memory copies and sets add to the time, not the count).
    (None, None) off the card."""
    if dev.type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    common.sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        common.sync(dev)
    device_us, kernels = 0.0, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device_us += evt.time_range.elapsed_us()
            kernels += not evt.name.startswith(("Memcpy", "Memset"))
    if kernels == 0:
        raise RuntimeError("torch.profiler recorded no CUDA kernel on the card")
    return device_us / n / 1e3, kernels / n


def _row(name, wall_ms, device_ms, kernels, note=""):
    busy = device_ms / wall_ms if device_ms is not None and wall_ms > 0 else None
    return {"stage": name, "wall_ms": wall_ms, "device_ms": device_ms, "kernels": kernels,
            "busy": busy, "note": note}


def _print_row(r, unit="ms"):
    dev = "n/a" if r["device_ms"] is None else f"{r['device_ms']:.3f}"
    ker = "n/a" if r["kernels"] is None else f"{r['kernels']:.0f}"
    busy = "n/a" if r["busy"] is None else f"{r['busy']:.1%}"
    print(f"{r['stage']:22s} {r['wall_ms']:10.3f} {unit}  device {dev} ms  "
          f"kernels {ker}  busy {busy}  {r['note']}", flush=True)


def _difference(name, a, b, c=None, note=""):
    """Row a - b (- c), column by column."""
    def diff(key):
        vals = [r[key] for r in (a, b, c) if r is not None]
        if any(v is None for v in vals):
            return None
        return vals[0] - sum(vals[1:])

    return {"stage": name, "wall_ms": diff("wall_ms"), "device_ms": diff("device_ms"),
            "kernels": diff("kernels"), "busy": None, "note": note}


def stage_rows(dev, reps: int = 30, prof_reps: int = 2, warm: int = 3):
    """The single-stream rows (eval_stages.py:177-220): features, odometry,
    full_step and mapping≈, at BENCH_CONFIG on scan ``warm`` of the
    sequence after ``warm`` real steps."""
    cfg = BENCH_CONFIG
    seq = synthetic.generate_sequence(
        n_scans=warm + 5, n_azimuth=900, seed=1, extent=30.0, radius=12.0,
        noise=0.01, closes_loop=False, speed=2.0,
    )
    cloud, imu, stamp = scan_inputs(seq, warm, cfg, dev)

    # warm a state by running a few real steps
    state = SlamState.init(cfg, dev)
    for k in range(warm):
        state, _ = slam_step(state, *scan_inputs(seq, k, cfg, dev), cfg)
    common.sync(dev)

    feats = functools.partial(F.extract_features, cfg=cfg)
    fx = feats(cloud)
    odostep = functools.partial(odo_mod.odometry_step, cfg=cfg)
    step = functools.partial(slam_step, cfg=cfg)

    rows = []
    for name, fn, args in (
        ("features", feats, (cloud,)),
        ("odometry", odostep, (state.odo, fx, imu, stamp)),
        ("full_step", step, (state, cloud, imu, stamp)),
    ):
        ms = _time(fn, args, dev, reps)
        d_ms, kernels = _device_profile(fn, args, dev, prof_reps)
        rows.append(_row(name, ms, d_ms, kernels))
    rows.append(_difference("mapping≈", rows[2], rows[1], rows[0], "(full - odo - features)"))
    return rows


def variant_configs(cfg):
    """``fleet_differential``'s fleet-step variants of ``cfg``."""
    nomap = dataclasses.replace(cfg, mapping_skip_frame=1_000_000_000)
    return {"full": cfg, "mapping skipped": nomap,
            "nomap + LM capped 1": dataclasses.replace(nomap, vgicp_max_iterations=1)}


def fleet_differential(B: int = 128, n_timed: int = 40, dev="cuda", prof_reps: int = 1):
    """Stage shares by configuration differences at fleet batch:

      full               — the bench fleet step (FLEET_CONFIG)
      mapping skipped    — mapping_skip_frame huge (the skip branch)
      + LM capped at 1   — vgicp_max_iterations=1 (registration share)
      features only      — vmapped extract_features on the same inputs

    Each variant: 4 warm-up steps, then the median over 3 repetitions of
    ``n_timed`` synchronized steps, and ``prof_reps`` profiled steps."""
    dev = torch.device(dev)
    cfg = FLEET_CONFIG
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs, _ = _stage_inputs(cfg, B, n_timed + 6, gen, dev)
    n_timed = min(n_timed, len(inputs) - 4 - prof_reps)

    def run_variant(name, vcfg, only_features=False):
        states = fleet.fleet_init(vcfg, B, dev)
        if only_features:
            feat = vmap(functools.partial(F.extract_features, cfg=vcfg))

            def step(st, cl, im, sp):
                with strict_vmap():
                    return st, feat(cl)
        else:
            step = functools.partial(fleet.fleet_step, cfg=vcfg)
        for k in range(4):
            states, out = step(states, *inputs[k])
        common.sync(dev)
        reps = []
        for _ in range(3):
            s = states
            t0 = time.perf_counter()
            for k in range(4, 4 + n_timed):
                s, out = step(s, *inputs[k])
            common.sync(dev)
            reps.append((time.perf_counter() - t0) / n_timed * 1e3)
        ms = statistics.median(reps)
        d_ms, kernels = _device_profile(step, (states, *inputs[4]), dev, prof_reps)
        row = _row(name, ms, d_ms, kernels, f"(B={B}, per fleet step)")
        _print_row(row, "ms/fleet-step")
        return row

    full, nomap, lm1 = (run_variant(name, vcfg) for name, vcfg in variant_configs(cfg).items())
    feat = run_variant("features only", cfg, only_features=True)
    shares = [_difference("mapping share≈", full, nomap),
              _difference("vgicp LM share≈", nomap, lm1),
              _difference("features≈", feat, None)]
    for r in shares:
        _print_row(r, "ms")
    return dict(full=full, nomap=nomap, lm1=lm1, feat=feat, shares=shares)


def fleet_breakdown(B: int = 128, iters: int = 20, dev="cuda"):
    """The three bodies of eval_stages.py:120-175 on the state after 4
    fleet steps and the 5th scan's inputs, each run ``iters`` times in one
    synchronized window: ms per step of features, features + odometry and
    the full fleet step; odometry≈ and mapping≈ by difference."""
    dev = torch.device(dev)
    cfg = FLEET_CONFIG
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs, _ = _stage_inputs(cfg, B, 6, gen, dev)
    states = fleet.fleet_init(cfg, B, dev)
    for k in range(4):
        states, _ = fleet.fleet_step(states, *inputs[k], cfg)
    common.sync(dev)
    cloud, imu, stamps = inputs[4]
    feats = vmap(functools.partial(F.extract_features, cfg=cfg))
    odo = vmap(functools.partial(odo_mod.odometry_step, cfg=cfg))

    def feat_body():
        with strict_vmap():
            return feats(cloud)

    def odo_body():
        with strict_vmap():
            return odo(states.odo, feats(cloud), imu, stamps)

    def full_body():
        return fleet.fleet_step(states, cloud, imu, stamps, cfg)

    rows = {}
    for name, body in (("features", feat_body), ("feat+odo", odo_body), ("full", full_body)):
        body()
        common.sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            body()
        common.sync(dev)
        rows[name] = (time.perf_counter() - t0) / iters * 1e3
        print(f"{name:10s} {rows[name]:8.3f} ms/step (B={B}, x{iters} in one window)",
              flush=True)
    print(f"{'odometry≈':10s} {rows['feat+odo'] - rows['features']:8.3f} ms/step")
    print(f"{'mapping≈':10s} {rows['full'] - rows['feat+odo']:8.3f} ms/step")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fleet", type=int, metavar="B", default=0,
                    help="run fleet_differential at B robots")
    ap.add_argument("--timed", type=int, default=40,
                    help="fleet steps per timed repetition (default 40)")
    ap.add_argument("--reps", type=int, default=30,
                    help="single-stream calls timed per stage (default 30)")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    print(f"device: {common.device_line(dev)}; {NO_FLOPS}", flush=True)
    if args.fleet:
        fleet_differential(args.fleet, args.timed, dev)
    else:
        for r in stage_rows(dev, args.reps):
            _print_row(r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
