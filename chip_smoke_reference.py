"""The JAX package's numbers that chip_smoke.py phases 4-7 hold the port to.

    JAX_PLATFORMS=cpu python3 chip_smoke_reference.py [--perturb SEED]
        [--control no-loops|no-pgo] [--fleet | --main | --cli | --rbf | --registration]
        [--eval [--eval-gates GATES [--quick]]] [--out FILE]

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
``--eval`` runs phase 10: the JAX harness's ``eval.run_sequence`` over the
first ``chip_smoke.EVAL_SCANS`` scans of ``eval.py``'s config 4 and config 3
quick sequences (``rgc_slam_tpu_torch.tools.eval.sequence``, held bit for
bit to the JAX package's by tests/test_torch_eval.py) and ``eval_pgo.py``'s
K=512 PGO case (``make_graph``, ``_pgo_solve`` jitted), with the PGO's own
largest change of the post-PGO ATE over three runs with the drifted
keyframe positions scaled by ``1 + 1e-7 * N(0, 1)``: ``EVAL_JAX`` and
``PGO_JAX``; ``--perturb`` perturbs the scans.  ``--eval --eval-gates
1,1p,...`` runs those gates of ``tools.eval`` instead (``--quick`` for the
quick sequences): ``eval.run_sequence`` on each single-stream gate, and
``eval.py``'s fleet code for 5_fleet and 5b: the JAX side of the port's
eval table.
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


def _head(seq: dict, n: int) -> dict:
    return {key: seq[key][:n] for key in ("scans", "imu", "stamps", "poses")}


def _perturbed_seq(seq: dict, seed: int) -> dict:
    return {**seq, "scans": [perturbed(s, seed * 1000 + k) for k, s in enumerate(seq["scans"])]}


def _fleet_gate(gate: str, seqs) -> dict:
    """eval.py's fleet configs 5 (one world, 64 robots, 4 steps) and 5b (4
    distinct courses with the fleet loop step, robot 0 against its B=1 run)
    on the given sequences (eval.py:274-380)."""
    import functools
    import jax
    import jax.numpy as jnp
    from rgc_slam_tpu.config import SlamConfig
    from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu.parallel import fleet
    from rgc_slam_tpu.utils.evaluation import ate_rmse
    from rgc_slam_tpu_torch.tools import eval as teval

    cfg = SlamConfig(**dataclasses.asdict(teval.gate_config(gate)))

    def lane_inputs(seq, k):
        t_imu, acc, gyr = seq["imu"][k]
        return (cloud_from_scan_dict(seq["scans"][k], cfg), imu_from_interval(t_imu, acc, gyr, cfg.max_imu),
                jnp.asarray(seq["stamps"][k], jnp.float32))

    fstep = jax.jit(functools.partial(fleet.fleet_step, cfg=cfg))
    if gate == "5_fleet":
        B = teval.FLEET_B
        states = fleet.fleet_init(cfg, B)
        for k in range(teval.FLEET_STEPS):
            batched = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), lane_inputs(seqs, k))
            states, outs = fstep(states, *batched)
        tm = np.asarray(outs.t_map)
        return {"robots": B, "cross_robot_spread_m": float(np.abs(tm - tm[:1]).max())}
    floop = jax.jit(functools.partial(fleet.fleet_loop_step, cfg=cfg))
    n5 = min(len(s5["scans"]) for s5 in seqs)

    def drive(streams):
        fstates, flstates = fleet.fleet_init(cfg, len(streams)), fleet.fleet_loop_init(cfg, len(streams))
        est = []
        for k in range(n5):
            batch = [jax.tree.map(lambda *x: jnp.stack(x), *lane) for lane in
                     zip(*(lane_inputs(s5, k) for s5 in streams))]
            fstates, fouts = fstep(fstates, *batch)
            est.append(np.asarray(fouts.t_map))
            if (k + 1) % cfg.loop_cadence == 0:
                fstates, flstates, _ = floop(fstates, flstates)
        return np.stack(est), flstates

    est5, flstates = drive(seqs)
    per_robot = [float(ate_rmse(est5[:, b], np.stack([t for (_, t) in s5["poses"]])))
                 for b, s5 in enumerate(seqs)]
    est1, _ = drive(seqs[:1])
    ate_b1 = float(ate_rmse(est1[:, 0], np.stack([t for (_, t) in seqs[0]["poses"]])))
    return {"robots": len(seqs), "n_scans": n5,
            "loops_per_robot": [int(x) for x in np.asarray(flstates.loop_count)],
            "ate_map_m_per_robot": per_robot, "ate_map_m_b1_stream0": ate_b1,
            "fleet_vs_b1_ate_delta_m": abs(per_robot[0] - ate_b1)}


def eval_record(a) -> dict:
    """Phase 10's JAX numbers; with ``--eval-gates`` the port's eval table's."""
    import functools
    import jax
    import eval as jeval
    import eval_pgo as jpgo
    from chip_smoke import EVAL_SCANS, EVAL_PGO_K, EVAL_PGO_CG
    from rgc_slam_tpu.config import SlamConfig
    from rgc_slam_tpu.models.loop import _pgo_solve
    from rgc_slam_tpu_torch.tools import eval as teval

    def jcfg(gate):
        return SlamConfig(**dataclasses.asdict(teval.gate_config(gate)))

    t0 = time.time()
    if a.eval_gates:
        out = {}
        for gate in a.eval_gates.split(","):
            seq = teval.sequence(gate, a.quick)
            if a.perturb:
                seq = ([_perturbed_seq(s, a.perturb * 10 + i) for i, s in enumerate(seq)]
                       if isinstance(seq, list) else _perturbed_seq(seq, a.perturb))
            if gate in ("5_fleet", "5b"):
                out[teval.GATES[gate][0]] = _fleet_gate(gate, seq)
            else:
                out[teval.GATES[gate][0]] = jeval.run_sequence(jcfg(gate), seq, teval.loop_every(gate))
            print(json.dumps({gate: out[teval.GATES[gate][0]]}), file=sys.stderr, flush=True)
        return {"eval_gates": a.eval_gates, "quick": a.quick, "perturb": a.perturb,
                "jax": jax.__version__, "results": out, "seconds": time.time() - t0}

    runs = {}
    for gate, n in EVAL_SCANS.items():
        seq = _head(teval.sequence(gate, True), n)
        if a.perturb:
            seq = _perturbed_seq(seq, a.perturb)
        runs[gate] = jeval.run_sequence(jcfg(gate), seq)
    cfg = SlamConfig(max_keyframes=EVAL_PGO_K, max_kf_corner=8, max_kf_surf=8, max_loops=8,
                     pgo_cg_iters=EVAL_PGO_CG)
    ms, ls, gt = jpgo.make_graph(cfg, EVAL_PGO_K)
    solve = jax.jit(functools.partial(_pgo_solve, cfg=cfg))
    after = jpgo.ate(solve(ms, ls).kf_t, gt, EVAL_PGO_K)
    devs = []
    for seed in (1, 2, 3):
        g = np.random.default_rng(seed)
        kf_t = np.asarray(ms.kf_t)
        moved = ms.replace(kf_t=jax.numpy.asarray(
            (kf_t * (1 + 1e-7 * g.standard_normal(kf_t.shape))).astype(np.float32)))
        devs.append(abs(jpgo.ate(solve(moved, ls).kf_t, gt, EVAL_PGO_K) - after))
    return {"eval": True, "perturb": a.perturb, "jax": jax.__version__,
            "ate_map_m": {g: r["ate_map_m"] for g, r in runs.items()}, "runs": runs,
            "pgo": {"K": EVAL_PGO_K, "ate_before_m": jpgo.ate(ms.kf_t, gt, EVAL_PGO_K),
                    "ate_after_m": after, "dev": max(devs), "devs": devs},
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
    p.add_argument("--eval", action="store_true", help="phase 10's eval runs instead of phase 5")
    p.add_argument("--eval-gates", default="",
                   help="with --eval: these gates of tools.eval (comma-separated) instead")
    p.add_argument("--quick", action="store_true", help="with --eval-gates: the quick sequences")
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

    if a.fleet or a.main or a.cli or a.rbf or a.registration or a.eval:
        record = (fleet_record if a.fleet else cli_record if a.cli
                  else registration_record if a.registration
                  else eval_record if a.eval else main_record)(a)
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
