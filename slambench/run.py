"""Run one cell of the benchmark once.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell names a
configuration (``slambench/configs/<name>.json``: the program's settings,
robots, sensor and driver) and a traffic mix (``slambench/traffic/<name>.json``).
The run builds its inputs on the card from the seed, sets up and warms the
program through the configuration's driver (``slambench/drivers/<driver>.py``),
then calls it back to back for ``--seconds`` (a closed loop: log replay).
Every metric is a reader of its own (``slambench/metrics/<name>.py``): with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a short ``torch.profiler`` sub-window after the window.

Once the window has closed, the plain reference (``slambench/reference``)
works out a seeded sample of the window's calls again and decides
``correct`` against the cell's limits (``slambench/limits/<cell>.json``).
Standard output ends with a set-up line and the result line; standard
error ends with each compared number beside its limit.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "rgc_slam_tpu")
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda"}
TOP_OPS = 10
SOAK_S = 20.0


def seconds_since_start() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (``rgc_slam_tpu_torch`` is not ``rgc_slam_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def cell(bench: dict, workload: str):
    """(workload entry, configuration file, traffic file, limits file)."""
    try:
        w = next(x for x in bench["workloads"] if x["name"] == workload)
    except StopIteration:
        raise SystemExit(f"unknown workload {workload!r}") from None
    c = next(x for x in bench["configs"] if x["name"] == w["config"])
    spec = load_json(c["file"])
    traffic = load_json("slambench", "traffic", w["traffic"] + ".json")
    limits = load_json("slambench", "limits", workload + ".json")
    return w, spec, traffic, limits


def metrics_for(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def read_metric(name: str, rec):
    mod = importlib.import_module("slambench.metrics." + name.replace(".", "_").replace("-", "_"))
    return mod.read(rec)


def card(dev) -> Dict[str, object]:
    import torch

    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.splitlines()
        power = out[dev.index or 0].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        power = None
    return {"name": torch.cuda.get_device_name(dev), "power_limit": power}


def traced(driver, spans, n_calls: int):
    """``n_calls`` calls under ``torch.profiler`` (host and device), each a
    host span ``call``: the ``record.Trace`` on the profiler's clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from slambench.record import SPAN_PREFIX, Trace

    loops = []
    spans.traced = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(SPAN_PREFIX + "traced_window"):
                for _ in range(n_calls):
                    with spans.span("call"):
                        driver.step_call()
                    loops.append(driver.last_loop)
                torch.cuda.synchronize()
    finally:
        spans.traced = False
    ops, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s, name = e.start_ns(), e.name()
        on_device = e.device_type() == cuda
        if name.startswith(SPAN_PREFIX):
            # a span's range on the device's row is an annotation, no work
            if not on_device:
                host.append((name[len(SPAN_PREFIX):], s, s + e.duration_ns()))
        elif on_device and not e.is_user_annotation():
            ops.append((name, s, s + e.duration_ns()))
    (_, w0, w1), = [h for h in host if h[0] == "traced_window"]
    call_spans = sorted((s, e) for n, s, e in host if n == "call")
    if len(call_spans) != n_calls:
        raise RuntimeError(f"the trace holds {len(call_spans)} call spans of {n_calls}")
    spans_in = [h for h in host if h[0] != "traced_window"]
    return Trace(ops=ops, spans=spans_in, t0_ns=w0, t1_ns=w1,
                 calls=[(s, e, lp) for (s, e), lp in zip(call_spans, loops)])


def breakdown(trace) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps labelled by the innermost host span open at their middle."""
    from slambench.record import idle_gaps, union_ns

    by_name: Dict[str, List] = {}
    for name, s, e in trace.ops:
        by_name.setdefault(name[:160], []).append((s, e))
    busy = sorted(((n, union_ns(iv, trace.t0_ns, trace.t1_ns) / 1e9) for n, iv in
                   by_name.items()), key=lambda x: -x[1])[:TOP_OPS]
    gaps = []
    for s, e in idle_gaps(trace):
        mid = (s + e) // 2
        open_ = [(-hs, he, n) for n, hs, he in trace.spans if hs <= mid < he]
        gaps.append([min(open_)[2] if open_ else "no span", (e - s) / 1e9])
    gaps.sort(key=lambda x: -x[1])
    return {"device_ops": [list(x) for x in busy], "idle_gaps": gaps[:TOP_OPS]}


def ate_m(est, gt) -> Optional[float]:
    """RMSE (m) of positions after the best rigid alignment (Kabsch)."""
    import numpy as np

    if len(est) < 3:
        return None
    P, Q = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    mp, mq = P.mean(0), Q.mean(0)
    U, _, Vt = np.linalg.svd((P - mp).T @ (Q - mq))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    return float(np.sqrt((((P - mp) @ R.T + mq - Q) ** 2).sum(1).mean()))


def soak(driver, seconds: float):
    """The end of set-up: untimed calls for ``seconds``.

    The card runs the replayed step up to 28% slower for the first seconds
    to a minute of some processes, at full clocks (PERF.md §6); the soak
    keeps most of that out of the window."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        driver.step_call()


def window(driver, spans, seconds: float):
    """Calls back to back until ``seconds`` have passed since the first
    began: ([Call], the window's seconds, up to the last call's end)."""
    from slambench.record import Call

    calls = []
    t_start = time.perf_counter_ns()
    while True:
        p0 = time.process_time_ns()
        c0 = time.perf_counter_ns()
        with spans.span("call"):
            n = driver.step_call()
        c1 = time.perf_counter_ns()
        calls.append(Call(c0, c1, n, driver.last_loop, time.process_time_ns() - p0))
        if c1 - t_start >= seconds * 1e9:
            return calls, (c1 - t_start) / 1e9


def call_table(calls, spans) -> Dict[str, list]:
    """Each window call's ms, its process CPU ms, and the ms of the host
    spans inside it, by span name (for the reader of a run's log)."""
    table: Dict[str, list] = {"ms": [round(c.ms, 3) for c in calls],
                              "cpu_ms": [round(c.cpu_ns / 1e6, 3) for c in calls]}
    inner = [sp for sp in spans.spans if sp.name != "call"]
    j = 0
    inner.sort(key=lambda sp: sp.t0_ns)
    for k, c in enumerate(calls):
        while j < len(inner) and inner[j].t0_ns < c.t0_ns:
            j += 1
        i = j
        while i < len(inner) and inner[i].t1_ns <= c.t1_ns:
            col = table.setdefault(inner[i].name + "_ms", [0.0] * len(calls))
            col[k] = round(col[k] + (inner[i].t1_ns - inner[i].t0_ns) / 1e6, 3)
            i += 1
    return table


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             import_s: float = 0.0, spec_override=None, traffic_override=None,
             soak_s: float = SOAK_S, out=sys.stdout, err=sys.stderr):
    """One run of one cell on ``device``; prints the set-up line and the
    result line on ``out`` and returns the result."""
    import torch

    from slambench.record import RunRecord, Spans
    from slambench.reference import compare

    w, spec, traffic, limits = cell(bench, workload)
    spec = spec_override(spec) if spec_override else spec
    traffic = traffic_override(traffic) if traffic_override else traffic
    dev = torch.device(device)
    timings: Dict[str, object] = {}
    spans = Spans()
    t0 = time.perf_counter()
    driver_mod = importlib.import_module("slambench.drivers." + spec["driver"])
    timings["import_s"] = time.perf_counter() - t0 + import_s
    driver = driver_mod.Driver(spec, traffic, seed, dev, spans, timings)
    soak(driver, soak_s)
    setup_s = seconds_since_start()

    cpu0 = time.process_time()
    driver.sample(seed)
    calls, window_s = window(driver, spans, seconds)
    driver.stop_sampling()
    timings["window_cpu_s"] = time.process_time() - cpu0
    print("calls " + json.dumps(call_table(calls, spans)), file=err)
    ms = sorted(c.ms for c in calls)
    print(f"window: {len(calls)} calls, {sum(c.scans for c in calls)} scans in {window_s:.6f} s "
          f"({timings['window_cpu_s']:.3f} s of process CPU); call ms min {ms[0]:.3f} median "
          f"{ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}", file=err)

    trace_rec = None
    if trace:
        for _ in range(driver.traced_offset()):
            driver.step_call()
        trace_rec = traced(driver, spans, driver_mod.TRACED_CALLS)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ate = driver.ate() if hasattr(driver, "ate") else None
    knn_searches = driver.knn_searches()
    driver.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rows = [compare.row(call, compare.reference(call, driver.ref_cfg, "float64"), driver.ref_cfg)
            for call in driver.calls()]
    timings["reference_s"] = time.perf_counter() - t0
    numbers = compare.summary(rows)
    for r in rows:
        print("sample " + json.dumps(r), file=err)
    print("diagnostic " + json.dumps({k: numbers[k] for k in compare.DIAGNOSTIC}), file=err)
    correct = all(numbers[k] <= limits[k] for k in compare.NUMBERS)
    found = forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=err)
        raise SystemExit(4)

    rec = RunRecord(workload=workload, calls=calls, window_s=window_s, setup_s=setup_s,
                    spans=spans, trace=trace_rec, knn_searches=knn_searches)
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        v = read_metric(m["name"], rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    info = card(dev)
    setup_line = {"setup": {**timings, "setup_s": setup_s, "card": info["name"],
                            "power_limit": info["power_limit"], "memory_peak_bytes": memory_peak,
                            "ate_m": ate, "calls": len(calls), "seed": seed}}
    print(json.dumps(setup_line), file=out, flush=True)
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": info["name"],
                  "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(rows),
              "failed": compare.failed_calls(rows, numbers, limits),
              "metrics": metrics, "device": device_rec}
    if trace_rec is not None:
        from slambench.record import union_ns

        device_rec["busy_s"] = union_ns([(s, e) for _, s, e in trace_rec.ops], trace_rec.t0_ns,
                                        trace_rec.t1_ns) / 1e9
        device_rec["window_s"] = trace_rec.window_s
        result["breakdown"] = breakdown(trace_rec)
    # an infinite gap (a NaN or a zero quaternion read) prints as the
    # largest float, so the line stays strict JSON
    numbers = {k: min(v, sys.float_info.max) for k, v in numbers.items()}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in compare.NUMBERS}
    for k in compare.NUMBERS:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "slambench", "_cache", sub)
    t0 = time.perf_counter()
    import torch

    import_s = time.perf_counter() - t0
    bench = load_json("BENCHMARK.json")
    w = next((x for x in bench["workloads"] if x["name"] == args.workload), None)
    if w is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"the cell needs {w['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
             import_s=import_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
