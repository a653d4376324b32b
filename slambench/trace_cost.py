"""What the program's tracer costs on one cell: ``SlamSystem(trace=True)``
against ``trace=False`` on the cell's configuration and traffic.

    python3 -m slambench.trace_cost --workload vlp16_single.open_drive --seed 7 \\
        --pairs 8 --calls 40

Two systems replay the same log, each in log order, in blocks of
``--calls`` calls: pair p runs its block on one system then on the other,
the order turning each pair (A B, B A, ...).  A call is the benchmark's:
the sweep's host arrays converted, ``process``, the pose on the host.  A
block's scans/s is its calls over its host seconds.  Then one call of each
under ``torch.profiler`` (host and CUDA runtime): the runtime calls by name,
those that make the host wait among them.  Prints one JSON line; ``--out``
also writes it to a file.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import Counter

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cudaStreamWaitEvent")


def _runtime_calls(system, call, dev) -> Counter:
    """The CUDA runtime calls (on the CPU: the operators) one call makes,
    by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        call(system)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    cuda = torch.autograd.DeviceType.CUDA
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() != cuda and e.name().startswith("cuda"))


def measure(spec: dict, traffic: dict, seed: int, pairs: int, calls: int, dev) -> dict:
    """The A/B of the module's docstring on ``dev``: the result line."""
    import torch
    import torch.utils._pytree as pytree

    from rgc_slam_tpu_torch.config import SlamConfig
    from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu_torch.models.slam import SlamSystem
    from slambench.run import card
    from slambench.traffic import raycast

    cfg = SlamConfig(**spec["slam_config"])
    warm = cfg.loop_cadence if spec["enable_loop"] else 2
    n_scans = warm + pairs * calls + 1
    gen = torch.Generator(device=dev).manual_seed(seed)
    log = raycast.make_log(traffic, spec["sensor"], raycast.world_seeds(seed, 1)[0], n_scans,
                           gen, dev)
    host = {k: v.cpu().numpy() for k, v in log["scans"].items()}
    scans = [{k: host[k][i] for k in host} for i in range(n_scans)]
    imu, stamps = log["imu"], log["stamps"]

    systems = {name: SlamSystem(cfg, enable_loop=spec["enable_loop"], device=dev, trace=on)
               for name, on in (("traced", True), ("untraced", False))}
    done = {name: 0 for name in systems}

    def call(system):
        name = "traced" if system.trace else "untraced"
        i = done[name]
        cloud = cloud_from_scan_dict(scans[i], cfg, dev)
        t_imu, acc, gyr = imu[i]
        system.process(cloud, imu_from_interval(t_imu, acc, gyr, cfg.max_imu, dev), stamps[i])
        done[name] += 1

    for system in systems.values():       # capture, and up to the first loop step
        for _ in range(warm):
            call(system)
    rates = {name: [] for name in systems}
    for p in range(pairs):
        order = ("traced", "untraced") if p % 2 == 0 else ("untraced", "traced")
        for name in order:
            t0 = time.perf_counter()
            for _ in range(calls):
                call(systems[name])
            rates[name].append(calls / (time.perf_counter() - t0))
    runtime = {name: dict(_runtime_calls(systems[name], call, dev)) for name in systems}
    same = all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(systems["traced"].state),
                                                  pytree.tree_leaves(systems["untraced"].state)))

    def spread(v):
        q = statistics.quantiles(v, n=4)
        return (q[2] - q[0]) / statistics.median(v)

    med = {name: statistics.median(v) for name, v in rates.items()}
    info = card(dev)
    return {"card": info["name"], "power_limit": info["power_limit"], "seed": seed,
            "pairs": pairs, "calls": calls, "scans_per_s": rates, "median": med,
            "spread": {k: spread(v) for k, v in rates.items()},
            "cost_pct": 100.0 * (1.0 - med["traced"] / med["untraced"]),
            "pair_ratio_median": statistics.median(
                t / u for t, u in zip(rates["traced"], rates["untraced"])),
            "same_state": same,
            "waits_per_call": {name: {k: v for k, v in runtime[name].items() if k in WAITS}
                               for name in runtime},
            "runtime_calls": runtime}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the tracer's cost on one cell")
    ap.add_argument("--workload", default="vlp16_single.open_drive")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from slambench.run import cell, load_json

    _, spec, traffic, _ = cell(load_json("BENCHMARK.json"), args.workload)
    line = measure(spec, traffic, args.seed, args.pairs, args.calls, torch.device("cuda:0"))
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
