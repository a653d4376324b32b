"""The JAX package's numbers that chip_smoke.py phases 4-7 hold the port to.

    JAX_PLATFORMS=cpu python3 chip_smoke_reference.py [--perturb SEED]
        [--control no-loops|no-pgo] [--fleet | --main | --cli | --rbf | --registration]
        [--out FILE]

Runs ``rgc_slam_tpu.models.slam.SlamSystem`` (loops on) over phase 5's
sequence and config (``chip_smoke.LOOP_SEQ_ARGS`` / ``LOOP_CFG``) on the
CPU and prints one JSON line: the trajectory ATE of ``t_map``, the
post-PGO keyframe ATE (each keyframe against the ground-truth pose of the
scan nearest its stamp), the accepted-loop count and every loop step's
flags, and the first accepted loop's constraint (scan, keyframe ids,
``loop_t``, ``loop_yaw``).  ``--perturb SEED`` scales every scan's coordinates by
``1 + 1e-7 * N(0, 1)`` (numpy generator ``SEED * 1000 + scan``): the spread
of those runs is the reference's own float32 sensitivity, which sets the
port's gate.  ``--control`` gives the readings a broken loop path would
give: ``no-loops`` runs the same config with the loop step off,
``no-pgo`` replaces the 4-DoF solve by the identity (loops are still
detected and stored).  One run takes about six minutes on one x86-64 CPU.

``--fleet`` runs ``rgc_slam_tpu.parallel.fleet.fleet_step_compacting``
instead, one lane for each of phase 6's worlds (bench.py's ``FLEET_CONFIG``,
``FLEET_SEQ_ARGS``, seeds ``FLEET_SEEDS``), and prints each world's
trajectory ATE (lanes are independent, so phase 6's tiling of the worlds
over 128 lanes does not change them); ``--perturb`` perturbs its scans
the same way.  ``--main`` runs phase 4's sequence and config
(``chip_smoke.SEQ_ARGS``) through ``slam_step`` and prints its ATE.
``--cli`` writes phase 7's sweep log (phase 4's first ``chip_smoke.CLI_SCANS``
scans) with the JAX package's ``write_sequence`` under
``rgc_slam_tpu_torch/_build/phase7_reference/``, runs the JAX CLI over it
(``rgc_slam_tpu.run.main(["--log", ..., "--no-loop"])``, the default config)
and prints the ATE of its ``pose_evo.txt``: ``ATE_JAX_CLI``.  ``--rbf``
runs phase 8b: phase 4's first ``chip_smoke.SHARD_SCANS`` scans through
``slam_step`` at ``SlamConfig(loop_closure_enable=False,
cov_estimation="rbf")`` and prints its ATE: ``ATE_JAX_RBF``.
``--registration`` runs phase 9: ``rgc_slam_tpu.ops.gicp``'s
``gicp_mp_register`` and ``ndt_register`` (d2d, p2d) at the default
``SlamConfig()`` on ``chip_smoke.registration_scene()``, jitted, and prints
each one's pose, iteration and correspondence counts and fitness, and its
own largest pose change over three runs with every coordinate of both
clouds scaled by ``1 + 1e-7 * N(0, 1)``: ``REG_JAX``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def perturbed(scan, seed: int):
    g = np.random.default_rng(seed)
    out = dict(scan)
    out["xyz"] = (scan["xyz"] * (1 + 1e-7 * g.standard_normal(scan["xyz"].shape))).astype(np.float32)
    return out


def fleet_record(a) -> dict:
    """Phase 6's worlds through the JAX fleet, one lane each."""
    import functools
    import jax
    import jax.numpy as jnp
    from chip_smoke import FLEET_SEEDS, FLEET_SEQ_ARGS
    from bench import FLEET_CONFIG
    from rgc_slam_tpu.io import synthetic
    from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu.parallel import fleet
    from rgc_slam_tpu.utils.evaluation import ate_rmse

    cfg = dataclasses.replace(FLEET_CONFIG, loop_closure_enable=False)
    seqs = [synthetic.generate_sequence(seed=s, **FLEET_SEQ_ARGS) for s in FLEET_SEEDS]
    step = jax.jit(functools.partial(fleet.fleet_step_compacting, cfg=cfg))
    states = fleet.fleet_init(cfg, len(seqs))
    t0 = time.time()
    est = []
    for k in range(len(seqs[0]["scans"])):
        lanes = []
        for b, seq in enumerate(seqs):
            scan = perturbed(seq["scans"][k], (a.perturb * 1000 + k) * 100 + b) if a.perturb else seq["scans"][k]
            t_imu, acc, gyr = seq["imu"][k]
            lanes.append((cloud_from_scan_dict(scan, cfg), imu_from_interval(t_imu, acc, gyr, cfg.max_imu),
                          jnp.asarray(seq["stamps"][k], jnp.float32)))
        batch = [jax.tree.map(lambda *x: jnp.stack(x), *[lane[j] for lane in lanes]) for j in range(3)]
        states, outs = step(states, *batch)
        est.append(np.asarray(outs.t_map))
    est = np.stack(est, 1)                                   # [worlds, scans, 3]
    ates = [float(ate_rmse(est[b], np.stack([t for (_, t) in seq["poses"]])))
            for b, seq in enumerate(seqs)]
    return {"perturb": a.perturb, "fleet": True, "jax": jax.__version__, "ates": ates,
            "seeds": list(FLEET_SEEDS), "scans": est.shape[1], "seconds": time.time() - t0}


def registration_record(a) -> dict:
    """Phase 9's registrations through the JAX package, and their own
    sensitivity to 1e-7 perturbations of the inputs."""
    import functools
    import jax
    import jax.numpy as jnp
    from chip_smoke import REG_METHODS, quat_gap, registration_scene
    from rgc_slam_tpu.config import SlamConfig
    from rgc_slam_tpu.ops import gicp

    cfg = SlamConfig()
    src, tgt, _, _ = registration_scene()
    t0 = time.time()
    out = {}
    for method, (fn_name, kw) in REG_METHODS.items():
        fn = jax.jit(functools.partial(getattr(gicp, fn_name), cfg=cfg, **kw))

        def run(s, t):
            return fn(jnp.asarray(s), jnp.ones(len(s), bool), jnp.asarray(t), jnp.ones(len(t), bool),
                      jnp.asarray([1.0, 0.0, 0.0, 0.0]), jnp.zeros(3))

        res = run(src, tgt)
        q, t = np.asarray(res.q), np.asarray(res.t)
        devs = []
        for seed in (1, 2, 3):
            g = np.random.default_rng(seed)
            ps = (src * (1 + 1e-7 * g.standard_normal(src.shape))).astype(np.float32)
            pt = (tgt * (1 + 1e-7 * g.standard_normal(tgt.shape))).astype(np.float32)
            r = run(ps, pt)
            devs.append(max(quat_gap(np.asarray(r.q), q), float(np.abs(np.asarray(r.t) - t).max())))
        out[method] = {"q": q.tolist(), "t": t.tolist(), "iterations": int(res.iterations),
                       "n_corr": int(res.n_corr), "fitness": float(res.fitness), "dev": max(devs),
                       "devs": devs}
    return {"registration": True, "jax": jax.__version__, "methods": out,
            "seconds": time.time() - t0}


def main_record(a) -> dict:
    """Phase 4's sequence and config through ``slam_step``; with ``--rbf``
    phase 8b's: its first SHARD_SCANS scans with rbf covariances."""
    import functools
    import jax
    import jax.numpy as jnp
    from chip_smoke import SEQ_ARGS, SHARD_SCANS
    from rgc_slam_tpu.config import SlamConfig
    from rgc_slam_tpu.io import synthetic
    from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu.models import slam
    from rgc_slam_tpu.utils.evaluation import ate_rmse

    cfg = SlamConfig(loop_closure_enable=False, **({"cov_estimation": "rbf"} if a.rbf else {}))
    seq = synthetic.generate_sequence(**SEQ_ARGS)
    if a.rbf:
        seq = {key: seq[key][:SHARD_SCANS] for key in ("scans", "imu", "stamps", "poses")}
    step = jax.jit(functools.partial(slam.slam_step, cfg=cfg))
    state = slam.SlamState.init(cfg)
    t0 = time.time()
    est = []
    for k, scan in enumerate(seq["scans"]):
        if a.perturb:
            scan = perturbed(scan, a.perturb * 1000 + k)
        t_imu, acc, gyr = seq["imu"][k]
        state, out = step(state, cloud_from_scan_dict(scan, cfg),
                          imu_from_interval(t_imu, acc, gyr, cfg.max_imu),
                          jnp.asarray(seq["stamps"][k], jnp.float32))
        est.append(np.asarray(out.t_map))
    gt = np.stack([t for (_, t) in seq["poses"]])
    return {"perturb": a.perturb, "main": True, "rbf": a.rbf, "scans": len(est), "jax": jax.__version__,
            "ate": float(ate_rmse(np.stack(est), gt)), "seconds": time.time() - t0}


def cli_record(a) -> dict:
    """Phase 7's sweep log through the JAX CLI."""
    import jax
    from chip_smoke import CLI_SCANS, ROOT, cli_sequence
    from rgc_slam_tpu import run
    from rgc_slam_tpu.io import synthetic
    from rgc_slam_tpu.runtime.loader import write_sequence
    from rgc_slam_tpu.utils.evaluation import ate_rmse

    d = os.path.join(ROOT, "rgc_slam_tpu_torch", "_build", "phase7_reference")
    os.makedirs(d, exist_ok=True)
    seq, gt = cli_sequence(synthetic, CLI_SCANS)
    write_sequence(os.path.join(d, "seq.slog"), seq)
    t0 = time.time()
    run.main(["--log", os.path.join(d, "seq.slog"), "--no-loop", "--out-dir", os.path.join(d, "out")])
    est = np.loadtxt(os.path.join(d, "out", "pose_evo.txt"))[:, 1:4]
    return {"cli": True, "scans": len(est), "jax": jax.__version__,
            "ate": float(ate_rmse(est, gt)), "seconds": time.time() - t0}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--perturb", type=int, default=0, help="0: the scans as generated")
    p.add_argument("--control", choices=("no-loops", "no-pgo"), default=None,
                   help="a control run: loop step off, or PGO made a no-op")
    p.add_argument("--fleet", action="store_true", help="phase 6's fleet instead of phase 5")
    p.add_argument("--main", action="store_true", help="phase 4 instead of phase 5")
    p.add_argument("--cli", action="store_true", help="phase 7's JAX CLI run instead of phase 5")
    p.add_argument("--rbf", action="store_true", help="phase 8b's rbf run instead of phase 5")
    p.add_argument("--registration", action="store_true",
                   help="phase 9's registrations instead of phase 5")
    p.add_argument("--out", default="", help="also write the JSON record here")
    a = p.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import LOOP_CFG, LOOP_SEQ_ARGS, gt_at_keyframes
    from rgc_slam_tpu.config import SlamConfig
    from rgc_slam_tpu.io import synthetic
    from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu.models import loop as loop_mod
    from rgc_slam_tpu.models import slam
    from rgc_slam_tpu.utils.evaluation import ate_rmse

    if a.fleet or a.main or a.cli or a.rbf or a.registration:
        record = (fleet_record if a.fleet else cli_record if a.cli
                  else registration_record if a.registration else main_record)(a)
        print(json.dumps(record), flush=True)
        if a.out:
            with open(a.out, "w") as f:
                json.dump(record, f)
        return 0

    cfg = SlamConfig(**LOOP_CFG)
    seq = synthetic.generate_sequence(**LOOP_SEQ_ARGS)
    if a.control == "no-pgo":
        loop_mod._pgo_solve = lambda ms, ls, cfg: ms
    system = slam.SlamSystem(cfg, enable_loop=a.control != "no-loops")
    steps, first_loop = [], {}
    loop_fn = system._loop_fn

    def spy(state, ls):
        state, ls, info = loop_fn(state, ls)
        steps.append({"frame": system._frame, "attempted": bool(info.attempted),
                      "accepted": bool(info.accepted), "candidate": int(info.candidate),
                      "fitness": float(info.fitness), "kf_count": int(state.mapping.kf_count)})
        if bool(info.accepted) and not first_loop:
            first_loop.update(frame=system._frame, loop_i=int(ls.loop_i[0]), loop_j=int(ls.loop_j[0]),
                              loop_t=np.asarray(ls.loop_t[0]).tolist(), loop_yaw=float(ls.loop_yaw[0]))
        return state, ls, info

    if loop_fn is not None:
        system._loop_fn = spy
    t0 = time.time()
    for k, scan in enumerate(seq["scans"]):
        if a.perturb:
            scan = perturbed(scan, a.perturb * 1000 + k)
        t_imu, acc, gyr = seq["imu"][k]
        system.process(cloud_from_scan_dict(scan, cfg), imu_from_interval(t_imu, acc, gyr, cfg.max_imu),
                       seq["stamps"][k])
    gt = np.stack([t for (_, t) in seq["poses"]])
    est = np.stack([t for _, _, t in system.trajectory])
    ms = system.state.mapping
    n_kf = int(ms.kf_count)
    record = {
        "perturb": a.perturb, "control": a.control, "jax": jax.__version__,
        "ate": float(ate_rmse(est, gt)),
        "kf_ate": float(ate_rmse(np.asarray(ms.kf_t[:n_kf]),
                                 gt_at_keyframes(np.asarray(ms.kf_stamp[:n_kf]), seq["stamps"], gt))),
        "loops": int(system.loop_state.loop_count) if loop_fn is not None else 0, "n_kf": n_kf,
        "steps": steps, "first_loop": first_loop,
        "seconds": time.time() - t0,
    }
    print(json.dumps(record), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(record, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
