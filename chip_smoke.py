"""Smoke test of the PyTorch port on one NVIDIA GPU: build, kernel check, main path.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and the exit code is
not 0):

1. device: requires CUDA (no CPU fallback) and prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the kNN kernel (rgc_slam_tpu_torch/csrc/knn.cu) with nvcc
   and prints registers and spills per k from ``-Xptxas -v``;
3. kernel vs plain: the kernel against ``knn_plain`` on the card, at the
   mapping association's shapes (512 x 8192 and 2048 x 32768, k=5), k=1,
   k=20 with a ragged N, all-masked points and exact ties; then split
   invariance: one chunk, the planned split and a ragged split give
   bit-identical results at both main-path shapes, at k=5 and k=20;
3b. timing: device time per call of the kernel and of the plain version,
   in turns, at the two main-path shapes, each beside its bound (the
   larger of 8 float32 operations per pair at 67 TFLOP/s and the bytes
   read and written at 3.35 TB/s).  If an earlier version of the kernel
   is staged at ``rgc_slam_tpu_torch/_build/knn_prev.cu`` (for example
   ``git show <commit>:rgc_slam_tpu_torch/csrc/knn.cu``, whose entry point
   takes no split), it is built beside the kernel and timed in turns with
   it;
4. main path: ``SlamSystem.process`` over a 30-scan synthetic VLP-16
   sequence (16 x 1800 points) at ``SlamConfig(loop_closure_enable=False)``
   on cuda:0, with the kernel's launch count read around the run, finite
   poses and the trajectory ATE held against the JAX package's ATE on the
   same sequence and config.

The line before the last is the card's name and power limit, the one
before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  The full compiler report and every
number go to ``chiprun_out/`` (``knn_ptxas.txt``, ``chip_smoke.json``).
"""
from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# The JAX package's trajectory ATE (map frame, metres) on the sequence and
# config of phase 4: rgc_slam_tpu.models.slam.slam_step under jax.jit, JAX
# 0.9.0 on the CPU (x86-64), SlamConfig(loop_closure_enable=False),
# synthetic.generate_sequence(n_scans=31, n_azimuth=1800, seed=5,
# extent=18.0, radius=8.0, noise=0.004, motion_distortion=True,
# closes_loop=False, speed=2.0), utils.evaluation.ate_rmse on t_map.
ATE_JAX = 0.019438966313960963
ATE_GATE = "1.05 * ATE_JAX + 0.01"

SEQ_ARGS = dict(n_scans=31, n_azimuth=1800, seed=5, extent=18.0, radius=8.0, noise=0.004,
                motion_distortion=True, closes_loop=False, speed=2.0)

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
MAIN_SHAPES = ("corner 512x8192 k=5", "surf 2048x32768 k=5")
PEAK_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3


def phase(name: str):
    print(f"== {name}", flush=True)


def device_phase(torch):
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def _ptxas_summary(report: str):
    """{kernel: [registers, spill store bytes, spill load bytes]} from
    ``-Xptxas -v`` output, kernels named knn_chunk<K> / knn_merge<K>."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"knn_(chunk|merge)_kernelILi(\d+)E", m.group(1))
            name = f"knn_{t.group(1)}<{t.group(2)}>" if t else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, [0, int(m.group(1)), int(m.group(2))])
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, [0, 0, 0])[0] = int(m.group(1))
    return out


def build_phase(knn_cuda):
    """Builds the kernel, and an earlier version where one is staged, with
    one nvcc each, started together."""
    phase("build")
    os.makedirs(OUT_DIR, exist_ok=True)
    prev = None
    prev_src = os.path.join(knn_cuda.BUILD_DIR, "knn_prev.cu")
    if os.path.exists(prev_src):
        prev_lib = os.path.join(knn_cuda.BUILD_DIR, "libknn_prev.so")
        prev = (subprocess.Popen([knn_cuda._nvcc(), *knn_cuda.NVCC_FLAGS, prev_src, "-o", prev_lib],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                prev_lib)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        path = knn_cuda.build(verbose=True)
    dt = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "knn_ptxas.txt"), "w") as f:
        f.write(buf.getvalue())
    print(f"built {path} in {dt:.2f} s (compiler report: chiprun_out/knn_ptxas.txt)")
    regs = _ptxas_summary(buf.getvalue())
    assert regs, "no kernel in the compiler report"
    for name, (n_reg, st, ld) in sorted(regs.items()):
        k = int(re.search(r"<(\d+)", name).group(1))
        if k in (1, 5, 20, 24):
            print(f"  {name}: {n_reg} registers, spill stores {st} B, spill loads {ld} B")
    prev_lib = None
    if prev is not None:
        log, _ = prev[0].communicate()
        assert prev[0].returncode == 0, f"nvcc of the staged earlier kernel failed:\n{log}"
        prev_lib = prev[1]
        print(f"built the staged earlier kernel {prev_lib}")
    return dt, regs, prev_lib


def _time_ms(torch, fn, reps: int = 50) -> float:
    """Device time of one call of ``fn``: CUDA events around ``reps`` calls,
    over the count, after warm-up.  A sleep kernel first holds the stream
    while the host queues the calls, so the time is the device's and not
    the host's dispatch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nq: int, n: int, k: int):
    """(least time in ms, what bounds it) for one call: 8 float32 operations
    per pair at PEAK_FLOPS, or queries, points, mask and outputs moved once
    at PEAK_BYTES."""
    t_ops = 8 * nq * n / PEAK_FLOPS
    t_bytes = (12 * nq + 13 * n + 8 * nq * k) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _prev_kernel(torch, lib_path):
    """The staged earlier kernel's C entry point (queries, points, mask,
    center, nq, n, k, out_d, out_i, stream) behind a call like the kernel's."""
    fn = ctypes.CDLL(lib_path).rgc_knn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3

    def call(q, p, m, k):
        out_d = torch.empty((q.shape[0], k), dtype=torch.float32, device=q.device)
        out_i = torch.empty((q.shape[0], k), dtype=torch.int32, device=q.device)
        center = q.mean(0)
        err = fn(q.data_ptr(), p.data_ptr(), m.data_ptr(), center.data_ptr(), q.shape[0],
                 p.shape[0], k, out_d.data_ptr(), out_i.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"earlier kernel launch failed: cudaError {err}"
        return out_d, out_i
    return call


def _check_case(torch, knn_ops, knn_cuda, q, p, m, k, exact: bool):
    """Kernel vs plain on one input.  Distances agree to 1e-5 x the scale
    max(|q|^2+|p|^2) (centred); an index may differ only where the kernel's
    point lies within that tolerance of the plain result's distance in
    float64 (a near-tie ordered differently by float32 rounding).  With
    ``exact`` everything must be equal."""
    d_k, i_k = knn_cuda.knn(q, p, m, k)
    d_p, i_p = knn_ops.knn_plain(q, p, m, k)
    if q.is_cuda:
        torch.cuda.synchronize()
    assert d_k.shape == d_p.shape == (q.shape[0], k) and i_k.dtype == torch.int32
    assert bool(((i_k >= 0) & (i_k < p.shape[0])).all()), "index out of range"
    c = q.mean(0)
    qc, pc = (q - c).double(), (p - c).double()
    scale = float((qc * qc).sum(-1).max() + (pc * pc).sum(-1).max())
    tol = 1e-5 * scale
    fin = torch.isfinite(d_p)
    assert bool((torch.isfinite(d_k) == fin).all()), "finite pattern differs"
    err = float((d_k - d_p)[fin].abs().max()) if bool(fin.any()) else 0.0
    if exact:
        assert torch.equal(i_k, i_p), "indices differ on an exact case"
        assert torch.equal(d_k, d_p), "distances differ on an exact case"
        return err, 0
    assert err <= tol, f"distance error {err} > tol {tol}"
    bad = i_k != i_p
    n_swapped = int(bad.sum())
    if n_swapped:
        rows = bad.nonzero()[:, 0]
        pts = pc[i_k[bad].long()]
        d_true = ((qc[rows] - pts) ** 2).sum(-1)
        gap = (d_true - d_p[bad].double()).abs()
        gap = torch.where(torch.isinf(d_p[bad]), torch.zeros_like(gap), gap)
        assert float(gap.max()) <= tol, f"index swap beyond tolerance: {float(gap.max())}"
    return err, n_swapped


def knn_cases(torch, dev):
    """The phase-3 inputs: (checked-to-tolerance cases, exact cases)."""
    g = np.random.default_rng(0)

    def cloud(n, lo, hi, offset=(0.0, 0.0, 0.0)):
        return torch.from_numpy((g.uniform(lo, hi, (n, 3)) + offset).astype(np.float32)).to(dev)

    def mask(n, keep=0.9):
        return torch.from_numpy(g.random(n) < keep).to(dev)

    off = (35.0, -12.0, 0.5)   # map-scale coordinates, as the mapping solve sees them
    cases = {
        "corner 512x8192 k=5": (cloud(512, -15, 15, off), cloud(8192, -20, 20, off), mask(8192), 5),
        "surf 2048x32768 k=5": (cloud(2048, -15, 15, off), cloud(32768, -20, 20, off), mask(32768), 5),
        "k=1 1000x4096": (cloud(1000, -10, 10), cloud(4096, -10, 10), mask(4096), 1),
        "k=20 ragged 700x5000": (cloud(700, -10, 10), cloud(5000, -10, 10), mask(5000), 20),
        "few unmasked 300x640 k=20": (cloud(300, -5, 5), cloud(640, -5, 5), mask(640, 0.02), 20),
    }
    # exact ties: integer grid points with duplicates; queries whose mean is
    # the origin, so centring and every distance are exact in float32
    grid = g.integers(-8, 9, (3000, 3)).astype(np.float32)
    grid[1500:] = grid[:1500]
    qs = g.integers(-8, 9, (255, 3)).astype(np.float32)
    qs = np.concatenate([qs, -qs.sum(0, keepdims=True)]).astype(np.float32)
    exact = {
        "exact ties 256x3000 k=8": (torch.from_numpy(qs).to(dev), torch.from_numpy(grid).to(dev),
                                    torch.ones(3000, dtype=torch.bool, device=dev), 8),
        "all masked 64x128 k=5": (cloud(64, -1, 1), cloud(128, -1, 1),
                                  torch.zeros(128, dtype=torch.bool, device=dev), 5),
    }
    return cases, exact


def kernel_phase(torch, knn_ops, knn_cuda, dev):
    phase("kernel vs plain")
    cases, exact = knn_cases(torch, dev)
    max_err = 0.0
    for name, (q, p, m, k) in list(cases.items()) + list(exact.items()):
        err, swapped = _check_case(torch, knn_ops, knn_cuda, q, p, m, k, exact=name in exact)
        max_err = max(max_err, err)
        print(f"  {name}: max |d_kernel - d_plain| = {err:.3e}, near-tie index swaps = {swapped}")
    return max_err, cases


def split_phase(torch, knn_cuda, cases):
    """One chunk, the planned split and a ragged split: bit-identical."""
    phase("split invariance")
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {}
    for name in MAIN_SHAPES:
        q, p, m, _ = cases[name]
        n = p.shape[0]
        ragged = next(s for s in (7, 5, 3) if n % -(-n // s))
        for k in (5, 20):
            plan = knn_cuda.split_plan(q.shape[0], n, k, num_sms)
            d1, i1 = knn_cuda.knn(q, p, m, k, chunks=1)
            for chunks in (plan.chunks, ragged):
                d, i = knn_cuda.knn(q, p, m, k, chunks=chunks)
                assert torch.equal(d, d1) and torch.equal(i, i1), f"{name} k={k} S={chunks} differs"
            plans[f"{name.split()[0]} k={k}"] = plan._asdict()
            print(f"  {q.shape[0]}x{n} k={k}: chunks 1 = {plan.chunks} (planned: blocks of "
                  f"{plan.threads} queries, {plan.blocks(q.shape[0])} blocks) = {ragged} (ragged): "
                  f"bit-identical")
    return plans


def timing_phase(torch, knn_ops, knn_cuda, cases, smi, prev=None):
    """Kernel and plain version in turns (plain, kernel, kernel, plain), and
    the staged earlier kernel in turns with the kernel where there is one."""
    phase("kernel timing")
    timings = {}
    for name in MAIN_SHAPES:
        q, p, m, k = cases[name]
        nq, n = q.shape[0], p.shape[0]
        plain = lambda: knn_ops.knn_plain(q, p, m, k)   # noqa: E731
        kern = lambda: knn_cuda.knn(q, p, m, k)          # noqa: E731
        t_plain = _time_ms(torch, plain)
        t_kern = _time_ms(torch, kern)
        t_kern2 = _time_ms(torch, kern)
        t_plain2 = _time_ms(torch, plain)
        bound, bound_by = bound_ms(nq, n, k)
        row = {"kernel_ms": [t_kern, t_kern2], "plain_ms": [t_plain, t_plain2],
               "bound_ms": bound, "bound_by": bound_by}
        print(f"  {name}: kernel {t_kern:.4f} / {t_kern2:.4f} ms, plain {t_plain:.4f} / "
              f"{t_plain2:.4f} ms, bound {bound * 1e3:.3f} us ({bound_by}), share of bound "
              f"{bound / t_kern:.2%} (device time per call, mean of 50 queued calls; {smi})")
        if prev is not None:
            d_e, i_e = prev(q, p, m, k)
            d_k, i_k = knn_cuda.knn(q, p, m, k)
            assert torch.equal(d_e, d_k) and torch.equal(i_e, i_k), "earlier kernel differs"
            old = lambda: prev(q, p, m, k)               # noqa: E731
            t_old = _time_ms(torch, old)
            t_new = _time_ms(torch, kern)
            t_new2 = _time_ms(torch, kern)
            t_old2 = _time_ms(torch, old)
            row.update(earlier_ms=[t_old, t_old2], kernel_vs_earlier_ms=[t_new, t_new2])
            print(f"  {name}: earlier kernel {t_old:.4f} / {t_old2:.4f} ms, kernel {t_new:.4f} / "
                  f"{t_new2:.4f} ms in turns (same results, bit for bit)")
        timings[name] = row
    return timings


def main_path_phase(torch, knn_cuda, smi):
    phase("main path")
    from rgc_slam_tpu_torch.config import SlamConfig
    from rgc_slam_tpu_torch.io import synthetic
    from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu_torch.models.slam import SlamSystem, trajectory_xyz
    from rgc_slam_tpu_torch.utils.evaluation import ate_rmse

    cfg = SlamConfig(loop_closure_enable=False)
    seq = synthetic.generate_sequence(**SEQ_ARGS)
    dev = torch.device("cuda:0")
    system = SlamSystem(cfg, device=dev)
    per_scan = 4 * cfg.map_opt_iterations     # edge x2 + plane x2 per outer iteration
    n_pts = int(seq["scans"][0]["xyz"].shape[0])
    print(f"  {len(seq['scans'])} scans of {n_pts} points, max_points={cfg.max_points}")

    knn_cuda.launches = 0
    walls, launches = [], []
    for k, scan in enumerate(seq["scans"]):
        t_imu, acc, gyr = seq["imu"][k]
        before = knn_cuda.launches
        t0 = time.perf_counter()
        cloud = cloud_from_scan_dict(scan, cfg, dev)
        imu = imu_from_interval(t_imu, acc, gyr, cfg.max_imu, dev)
        out = system.process(cloud, imu, seq["stamps"][k])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(knn_cuda.launches - before)
        assert out.t_map.shape == (3,) and out.q_map.shape == (4,)
    total_launches = knn_cuda.launches

    est = trajectory_xyz(system)
    quats = np.stack([q for _, q, _ in system.trajectory])
    assert np.isfinite(est).all() and np.isfinite(quats).all(), "non-finite pose"
    assert np.allclose(np.linalg.norm(quats, axis=1), 1.0, atol=1e-4), "non-unit quaternion"
    assert all(n == per_scan for n in launches), f"kNN launches per scan {launches}"
    gt = np.stack([t for (_, t) in seq["poses"]])
    ate = ate_rmse(est, gt)
    gate = 1.05 * ATE_JAX + 0.01
    print(f"  ATE {ate:.5f} m (JAX {ATE_JAX:.5f} m, gate {ATE_GATE} = {gate:.5f} m)")
    assert ate <= gate, f"ATE {ate} above {gate}"
    med = statistics.median(walls)
    p90 = float(np.percentile(walls, 90))
    steady = walls[2:]
    print(f"  wall ms/scan: median {med:.1f}, p90 {p90:.1f} (all {len(walls)} scans); "
          f"median {statistics.median(steady):.1f} after 2 warm-up scans — {smi}")
    print("  wall ms per scan: " + " ".join(f"{w:.1f}" for w in walls))
    print(f"  kNN kernel launches: {total_launches} ({per_scan} per scan)")
    return {"ate_m": ate, "ate_jax_m": ATE_JAX, "wall_ms": walls, "median_ms": med,
            "p90_ms": p90, "launches": total_launches, "launches_per_scan": launches}


def main() -> int:
    import torch

    smi = device_phase(torch)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import rgc_slam_tpu_torch  # noqa: F401  (precision pins)
    from rgc_slam_tpu_torch.ops import knn as knn_ops
    from rgc_slam_tpu_torch.ops.cuda import knn as knn_cuda

    build_s, regs, prev_lib = build_phase(knn_cuda)
    max_err, cases = kernel_phase(torch, knn_ops, knn_cuda, torch.device("cuda:0"))
    plans = split_phase(torch, knn_cuda, cases)
    prev = _prev_kernel(torch, prev_lib) if prev_lib else None
    timings = timing_phase(torch, knn_ops, knn_cuda, cases, smi, prev)
    main = main_path_phase(torch, knn_cuda, smi)

    surf = timings["surf 2048x32768 k=5"]
    record = {"kernels": [{
        "name": "knn",
        "route": "cuda",
        "source": "rgc_slam_tpu_torch/csrc/knn.cu",
        "replaces": "rgc_slam_tpu/ops/pallas/knn_kernel.py:92",
        "launches": main["launches"],
        "max_abs_err": max_err,
        "ms": surf["kernel_ms"][0],
        "plain_ms": surf["plain_ms"][0],
        "bound_ms": surf["bound_ms"],
        "bound_by": surf["bound_by"],
        "library_ms": None,          # no one PyTorch call computes this function
        "chunks": plans["surf k=5"]["chunks"],
    }]}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build_s": build_s, "registers_spills": regs, "plans": plans,
                   "timings": timings, "main_path": main, "record": record}, f, indent=1)
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
