"""The port and chip_smoke.py work on a machine without JAX.

Each check runs in a subprocess in which ``import jax`` / ``import flax``
fail, as on the GPU machine, which has torch but no JAX.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_JAX = """
import sys
sys.modules["jax"] = None      # any import of jax or flax now raises ImportError
sys.modules["flax"] = None
"""


def _run(code: str, cwd: str = REPO, timeout: int = 300):
    env = dict(os.environ, PYTHONPATH=REPO if cwd == REPO else "", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", NO_JAX + textwrap.dedent(code)], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_port_runs_without_jax():
    proc = _run("""
        import dataclasses, json, os
        import torch
        torch.set_num_threads(1)
        import rgc_slam_tpu_torch
        from rgc_slam_tpu_torch.config import TEST_CONFIG
        from rgc_slam_tpu_torch.io import synthetic
        from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
        from rgc_slam_tpu_torch.models.slam import SlamSystem
        cfg = dataclasses.replace(TEST_CONFIG, loop_closure_enable=False)
        seq = synthetic.generate_sequence(
            n_scans=3, n_azimuth=120, seed=5, extent=18.0, radius=8.0, noise=0.004,
            closes_loop=False, speed=2.0)
        system = SlamSystem(cfg, device="cpu")
        for k in range(2):
            t, a, g = seq["imu"][k]
            out = system.process(cloud_from_scan_dict(seq["scans"][k], cfg, "cpu"),
                                 imu_from_interval(t, a, g, cfg.max_imu, "cpu"), seq["stamps"][k])
        assert bool(torch.isfinite(out.t_map).all())
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "rgc_slam_tpu"))
        jax_pkg = os.path.join(os.getcwd(), "rgc_slam_tpu") + os.sep
        files = sorted(m for m, mod in list(sys.modules.items())
                       if os.path.abspath(getattr(mod, "__file__", None) or "").startswith(jax_pkg))
        print(json.dumps({"loaded": loaded, "files": files,
                          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                          "precision": torch.get_float32_matmul_precision()}))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info["loaded"] == ["flax", "jax"], info      # only the blocking stubs
    assert info["files"] == [], info                    # no file of the JAX package ran
    assert info["allow_tf32"] is False and info["precision"] == "highest"


def test_loop_path_runs_without_jax():
    """SlamSystem with loops on across one loop_cadence boundary, with
    models/loop.py and ops/gicp.py imported: no file of the JAX package
    is loaded."""
    proc = _run("""
        import dataclasses, json, os
        import torch
        torch.set_num_threads(1)
        from rgc_slam_tpu_torch.config import TEST_CONFIG
        from rgc_slam_tpu_torch.io import synthetic
        from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
        from rgc_slam_tpu_torch.models.slam import SlamSystem
        from rgc_slam_tpu_torch.ops import gicp  # noqa: F401
        cfg = dataclasses.replace(TEST_CONFIG, loop_cadence=2)
        assert cfg.loop_closure_enable
        seq = synthetic.generate_sequence(
            n_scans=4, n_azimuth=120, seed=5, extent=18.0, radius=8.0, noise=0.004,
            closes_loop=False, speed=2.0)
        system = SlamSystem(cfg, device="cpu")
        for k in range(3):
            t, a, g = seq["imu"][k]
            system.process(cloud_from_scan_dict(seq["scans"][k], cfg, "cpu"),
                           imu_from_interval(t, a, g, cfg.max_imu, "cpu"), seq["stamps"][k])
        jax_pkg = os.path.join(os.getcwd(), "rgc_slam_tpu") + os.sep
        print(json.dumps({
            "port": sorted(m for m in sys.modules if m in (
                "rgc_slam_tpu_torch.models.loop", "rgc_slam_tpu_torch.ops.gicp")),
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "flax", "rgc_slam_tpu")),
            "files": sorted(m for m, mod in list(sys.modules.items())
                            if os.path.abspath(getattr(mod, "__file__", None) or "").startswith(jax_pkg)),
            "last_kf_count": int(system.loop_state.last_kf_count),
            "kf_count": int(system.state.mapping.kf_count)}))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info["port"] == ["rgc_slam_tpu_torch.models.loop", "rgc_slam_tpu_torch.ops.gicp"]
    assert info["loaded"] == ["flax", "jax"], info
    assert info["files"] == [], info
    assert 0 < info["last_kf_count"] <= info["kf_count"], info     # the loop step ran


def test_fleet_runs_without_jax():
    """parallel/fleet.py and utils/lanes.py: two robots through one fleet
    step and one fleet loop step, with no file of the JAX package loaded."""
    proc = _run("""
        import dataclasses, json, os
        import torch
        torch.set_num_threads(1)
        from rgc_slam_tpu_torch.config import TEST_CONFIG
        from rgc_slam_tpu_torch.io import synthetic
        from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
        from rgc_slam_tpu_torch.parallel import fleet
        from rgc_slam_tpu_torch.types import tree_stack
        cfg = dataclasses.replace(TEST_CONFIG, inline_compaction=False)
        seq = synthetic.generate_sequence(
            n_scans=2, n_azimuth=120, seed=5, extent=18.0, radius=8.0, noise=0.004,
            closes_loop=False, speed=2.0)
        t, a, g = seq["imu"][0]
        one = (cloud_from_scan_dict(seq["scans"][0], cfg, "cpu"),
               imu_from_interval(t, a, g, cfg.max_imu, "cpu"),
               torch.tensor(seq["stamps"][0], dtype=torch.float32))
        batch = [tree_stack([x, x]) for x in one]
        states, outs = fleet.fleet_step_compacting(fleet.fleet_init(cfg, 2, "cpu"), *batch, cfg)
        states, ls, info = fleet.fleet_loop_step(states, fleet.fleet_loop_init(cfg, 2, "cpu"), cfg)
        assert bool(torch.isfinite(outs.t_map).all()) and info.attempted.shape == (2,)
        jax_pkg = os.path.join(os.getcwd(), "rgc_slam_tpu") + os.sep
        print(json.dumps({
            "port": sorted(m for m in sys.modules if m in (
                "rgc_slam_tpu_torch.parallel.fleet", "rgc_slam_tpu_torch.utils.lanes")),
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "flax", "rgc_slam_tpu")),
            "files": sorted(m for m, mod in list(sys.modules.items())
                            if os.path.abspath(getattr(mod, "__file__", None) or "").startswith(jax_pkg))}))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info["port"] == ["rgc_slam_tpu_torch.parallel.fleet", "rgc_slam_tpu_torch.utils.lanes"]
    assert info["loaded"] == ["flax", "jax"], info
    assert info["files"] == [], info


def test_sharded_step_runs_without_jax():
    """One sharded slam_step (sp front-end, point-sharded registration and
    mapping) on 2 gloo ranks spawned by ``parallel.distributed.run_ranks``:
    neither the caller nor a rank loads JAX or a file of the JAX package."""
    proc = _run("""
        import dataclasses, json, os
        sys.path.insert(0, "tests")          # the rank bodies; spawned ranks inherit the path
        import torch
        torch.set_num_threads(1)
        import torch_sp_ranks
        from rgc_slam_tpu_torch.config import TEST_CONFIG
        from rgc_slam_tpu_torch.io import synthetic
        from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
        from rgc_slam_tpu_torch.parallel.distributed import run_ranks
        from rgc_slam_tpu_torch.types import tree_items
        cfg = dataclasses.replace(TEST_CONFIG, psum_axis="sp", sp_shards=2, sp_features=True)
        seq = synthetic.generate_sequence(
            n_scans=2, n_azimuth=120, seed=7, extent=15.0, radius=6.0, noise=0.004,
            closes_loop=False, speed=1.5)
        t, a, g = seq["imu"][0]
        scan = ({n: v.numpy() for n, v in tree_items(cloud_from_scan_dict(seq["scans"][0], cfg, "cpu"))},
                {n: v.numpy() for n, v in tree_items(imu_from_interval(t, a, g, cfg.max_imu, "cpu"))},
                float(seq["stamps"][0]))
        outs = run_ranks(torch_sp_ranks.sharded_step_modules, 2, "cpu", (scan, cfg), timeout_s=200)
        jax_pkg = os.path.join(os.getcwd(), "rgc_slam_tpu") + os.sep
        print(json.dumps({
            "finite": all(bool((o[0] == o[0]).all()) for o in outs),
            "ranks": [[o[1], o[2]] for o in outs],
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "flax", "rgc_slam_tpu")),
            "files": sorted(m for m, mod in list(sys.modules.items())
                            if os.path.abspath(getattr(mod, "__file__", None) or "").startswith(jax_pkg))}))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info["finite"], info
    assert info["loaded"] == ["flax", "jax"] and info["files"] == [], info
    assert info["ranks"] == [[[], []], [[], []]], info      # no rank imported any of it


def test_cli_runs_without_jax(tmp_path):
    """``python -m rgc_slam_tpu_torch.run --log`` over 2 scans, with the
    sweep-log library built and loaded: no file of the JAX package is
    imported or mapped into the process (its ``libsweeplog.so`` included)."""
    proc = _run(f"""
        import dataclasses, json, os, runpy
        import torch
        torch.set_num_threads(1)
        from rgc_slam_tpu_torch import config
        from rgc_slam_tpu_torch.io import synthetic
        from rgc_slam_tpu_torch.runtime.loader import write_sequence
        small = config.TEST_CONFIG
        config.SlamConfig = lambda **kw: dataclasses.replace(small, **kw)
        seq = synthetic.generate_sequence(
            n_scans=3, n_azimuth=120, seed=5, extent=18.0, radius=8.0, noise=0.004,
            closes_loop=False, speed=2.0)
        out = {str(tmp_path)!r}
        write_sequence(os.path.join(out, "s.slog"), seq)
        sys.argv = ["run", "--log", os.path.join(out, "s.slog"), "--dump-frames", "--device", "cpu",
                    "--out-dir", os.path.join(out, "o")]
        runpy.run_module("rgc_slam_tpu_torch.run", run_name="__main__")
        jax_pkg = os.path.join(os.getcwd(), "rgc_slam_tpu") + os.sep
        maps = [line.split()[-1] for line in open("/proc/self/maps") if line.count(" ") >= 5]
        print(json.dumps({{
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "flax", "rgc_slam_tpu")),
            "files": sorted(m for m, mod in list(sys.modules.items())
                            if os.path.abspath(getattr(mod, "__file__", None) or "").startswith(jax_pkg)),
            "libs": sorted({{p for p in maps if p.endswith(".so")
                            and "rgc_slam_tpu" in p}}),
            "jax_libs": sorted({{p for p in maps if p.startswith(jax_pkg)}})}}))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info["loaded"] == ["flax", "jax"], info
    assert info["files"] == [] and info["jax_libs"] == [], info
    assert info["libs"] == [os.path.join(REPO, "rgc_slam_tpu_torch", "_build", "libsweeplog.so")]
    poses = [line.split() for line in open(tmp_path / "o" / "pose_evo.txt")]
    assert len(poses) == 2 and len(os.listdir(tmp_path / "o" / "frames")) == 2


def test_registration_and_oracles_run_without_jax():
    """The registration library, the factor library's ``gauss_newton``, the
    copied numpy modules and ``utils/parity_gates``: phase 9's calls on a
    small ``chip_smoke.registration_scene`` and two of phase 9b's gates, on
    the CPU, with no file of the JAX package loaded."""
    proc = _run("""
        import json, os
        import torch
        torch.set_num_threads(1)
        import chip_smoke
        from rgc_slam_tpu_torch.config import SlamConfig
        from rgc_slam_tpu_torch.io import gnss
        from rgc_slam_tpu_torch.ops import factors, gicp, imu
        from rgc_slam_tpu_torch.types import Pose, Scan
        from rgc_slam_tpu_torch.utils import oracle, parity, parity_gates
        src, tgt, q_gt, t_gt = chip_smoke.registration_scene(300, 1200)
        ones = lambda a: torch.ones(len(a), dtype=torch.bool)
        args = (torch.from_numpy(src), ones(src), torch.from_numpy(tgt), ones(tgt),
                Pose.identity("cpu").q, Pose.identity("cpu").t, SlamConfig())
        errs = {}
        for method, (fn, kw) in chip_smoke.REG_METHODS.items():
            res = getattr(gicp, fn)(*args, **kw)
            errs[method] = float((res.t - torch.from_numpy(t_gt)).abs().max())
        x = factors.gauss_newton(lambda x: x - 1.0, 3, 2, device="cpu")
        for gate in ("vgicp_linearize", "deskew"):
            parity_gates.GATES[gate]("cpu")
        jax_pkg = os.path.join(os.getcwd(), "rgc_slam_tpu") + os.sep
        print(json.dumps({
            "errs": errs, "x": x.tolist(), "gnss": gnss.gnss_to_xyz(
                gnss.GnssFix(1, 45.00001, 10.0, 1.0), gnss.GnssFix(0, 45.0, 10.0, 0.0)).tolist(),
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "flax", "rgc_slam_tpu")),
            "files": sorted(m for m, mod in list(sys.modules.items())
                            if os.path.abspath(getattr(mod, "__file__", None) or "").startswith(jax_pkg))}))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info["loaded"] == ["flax", "jax"] and info["files"] == [], info
    assert max(info["errs"].values()) < 0.1, info
    assert max(abs(v - 1.0) for v in info["x"]) < 1e-5 and abs(info["gnss"][1] - 1.112) < 0.01, info


def test_tools_import_without_jax():
    """Every module of ``rgc_slam_tpu_torch.tools`` imports with JAX blocked,
    and none loads a file of the JAX package, the root ``eval*.py``,
    ``bench.py`` or ``__graft_entry__.py``."""
    proc = _run("""
        import importlib, json, os, pkgutil
        import rgc_slam_tpu_torch.tools as tools
        names = sorted(m.name for m in pkgutil.iter_modules(tools.__path__))
        for name in names:
            importlib.import_module(f"rgc_slam_tpu_torch.tools.{name}")
        root = os.getcwd() + os.sep
        jax_pkg = os.path.join(root, "rgc_slam_tpu") + os.sep
        files = sorted(f for f in (getattr(mod, "__file__", None) or ""
                                   for mod in list(sys.modules.values())) if os.path.isabs(f))
        print(json.dumps({
            "names": names,
            "loaded": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "flax", "rgc_slam_tpu", "bench",
                                                    "__graft_entry__")
                             or m.split(".")[0].startswith("eval")),
            "jax_files": [f for f in files if f.startswith(jax_pkg)
                          or (os.path.dirname(f) + os.sep == root and f.endswith(".py"))]}))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"eval", "eval_stages", "eval_pgo", "eval_longrun", "eval_longrun_fleet",
            "eval_sp", "eval_sp_feature_probe", "bench", "graft_entry"} <= set(info["names"]), info
    assert info["loaded"] == ["flax", "jax"], info
    assert info["jax_files"] == [], info


def test_chip_smoke_fails_without_gpu():
    """No CUDA device here: nonzero exit and no result line."""
    proc = _run("""
        import runpy
        runpy.run_path("chip_smoke.py", run_name="__main__")
    """)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run("""
        import runpy
        runpy.run_path("chip_smoke.py", run_name="__main__")
    """, cwd=str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
