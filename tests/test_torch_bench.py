"""``rgc_slam_tpu_torch.tools.bench`` against the root ``bench.py``.

* BENCH_CONFIG, FLEET_CONFIG, N_WARMUP and every knob's default equal
  ``bench.py``'s, and the knobs are read from the same environment
  variables.
* ``main --device cpu`` at B=2, 2 timed steps in chunks of 2, one window,
  the single stream skipped (FLEET_CONFIG shrunk to TEST_CONFIG's
  capacities, as tests/test_torch_eval_stages_cpu.py does) prints exactly
  one JSON line whose keys are those of ``bench.py``'s line (read from its
  source with ``ast``) less the serialized mode's two and the CPU
  fallback's note, plus ``power_limit``; every rate finite and positive.
* Without CUDA the default device raises, and a run whose step raises
  prints ``bench.py``'s error line as its one stdout line and exits
  non-zero.
"""
import ast
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from rgc_slam_tpu_torch import config as tcfg
from rgc_slam_tpu_torch.tools import bench

import torch_eval_roots

torch.set_num_threads(1)
REPO = torch_eval_roots.REPO
KNOBS = ("FLEET_B", "N_SEEDS", "N_WARMUP", "N_TIMED", "N_REPS", "SKIP_SINGLE", "SKIP_LOOPS", "CHUNK")
DROPPED = {"dispatch_probe_ms_per_step", "serialized_threshold_ms", "platform_note"}
RATES = ("value", "per_dispatch_scans_per_sec", "with_loops_scans_per_sec")


def _dict_keys(node) -> set:
    """String keys of a dict display, with those of the dicts that its
    ``**`` entries expand (bench.py's conditional ``platform_note``)."""
    keys = set()
    for k, v in zip(node.keys, node.values):
        if k is None:
            keys |= {key for sub in ast.walk(v) if isinstance(sub, ast.Dict)
                     for key in _dict_keys(sub)}
        elif isinstance(k, ast.Constant):
            keys.add(k.value)
    return keys


def _bench_py_dumps(function: str) -> set:
    """The keys of the dict that ``bench.py``'s ``function`` passes to
    ``json.dumps``."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == function)
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps")
    return _dict_keys(call.args[0])


@pytest.fixture(scope="module")
def cpu_line():
    small = dataclasses.replace(tcfg.TEST_CONFIG, inline_compaction=False)
    patch = dict(FLEET_CONFIG=small, FLEET_B=2, N_TIMED=2, CHUNK=2, N_REPS=1, SKIP_SINGLE=True)
    saved = {name: getattr(bench, name) for name in patch}
    for name, value in patch.items():
        setattr(bench, name, value)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--device", "cpu"])
    finally:
        for name, value in saved.items():
            setattr(bench, name, value)
    return rc, buf.getvalue()


def test_configs_and_knobs_match_bench_py():
    jbench = torch_eval_roots.load("bench")
    assert not any(k.startswith("RGC_BENCH_") for k in os.environ)
    assert dataclasses.asdict(bench.BENCH_CONFIG) == dataclasses.asdict(jbench.BENCH_CONFIG)
    assert dataclasses.asdict(bench.FLEET_CONFIG) == dataclasses.asdict(jbench.FLEET_CONFIG)
    for name in KNOBS:
        assert getattr(bench, name) == getattr(jbench, name), name
    assert (bench.FLEET_B, bench.N_SEEDS, bench.N_WARMUP, bench.N_TIMED, bench.N_REPS,
            bench.CHUNK, bench.SKIP_SINGLE, bench.SKIP_LOOPS) == (128, 8, 5, 40, 5, 8, False, False)


def test_knobs_read_from_the_environment():
    env = dict(os.environ, PYTHONPATH=REPO, RGC_BENCH_B="3", RGC_BENCH_SEEDS="2",
               RGC_BENCH_TIMED="16", RGC_BENCH_REPS="3", RGC_BENCH_CHUNK="4",
               RGC_BENCH_SKIP_SINGLE="1", RGC_BENCH_SKIP_LOOPS="1")
    code = ("import json; from rgc_slam_tpu_torch.tools import bench; "
            f"print(json.dumps([getattr(bench, n) for n in {list(KNOBS)!r}]))")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout) == [3, 2, 5, 16, 3, True, True, 4]


def test_line_has_bench_py_keys(cpu_line):
    rc, out = cpu_line
    line = json.loads(out.strip().splitlines()[-1])
    expect = (_bench_py_dumps("main") - DROPPED) | {"power_limit"}
    assert DROPPED <= _bench_py_dumps("main")
    assert set(line) == expect, set(line) ^ expect


def test_main_on_cpu_prints_one_line(cpu_line):
    rc, out = cpu_line
    lines = out.strip().splitlines()
    assert rc == 0 and len(lines) == 1, lines
    line = json.loads(lines[0])
    for key in RATES:
        assert isinstance(line[key], float) and math.isfinite(line[key]) and line[key] > 0, key
    assert line["vs_baseline"] == round(line["value"] / 10.0, 2)
    assert "2-robot vmap fleet" in line["metric"] and "median of 1" in line["metric"]
    assert "2-scan dispatch chunks" in line["metric"] and line["unit"] == "scans/sec"
    assert line["single_stream_ms_per_scan"] is None and line["dispatch_mode"] == "pipelined"
    assert line["platform"] == "cpu" and line["device"] == "cpu" and line["power_limit"] is None
    assert line["fleet_step_gflops"] is None and line["mfu_pct_vs_bf16_peak"] is None
    assert len(line["host_loadavg_1_5_15"]) == len(line["host_loadavg_end_1_5_15"]) == 3


def test_default_device_raises_without_cuda():
    assert not torch.cuda.is_available()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == _bench_py_dumps("_emit_error")
    assert line["error"] == "bench_failed" and line["value"] is None


def test_failed_run_prints_the_error_line_and_exits_nonzero():
    code = textwrap.dedent("""
        import runpy, sys
        from rgc_slam_tpu_torch.parallel import fleet

        def broken(*args, **kw):
            raise ValueError("the step fails on purpose")

        fleet.fleet_step_compacting = broken
        sys.argv = ["bench", "--device", "cpu"]
        runpy.run_module("rgc_slam_tpu_torch.tools.bench", run_name="__main__")
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", RGC_BENCH_B="2",
               RGC_BENCH_TIMED="2", RGC_BENCH_CHUNK="2", RGC_BENCH_REPS="1",
               RGC_BENCH_SKIP_SINGLE="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert set(line) == _bench_py_dumps("_emit_error")
    assert line["error"] == "bench_failed" and line["value"] is None
    assert "ValueError: the step fails on purpose" in line["detail"]
    assert "fails on purpose" in proc.stderr          # the traceback
