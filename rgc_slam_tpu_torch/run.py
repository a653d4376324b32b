"""CLI runner: the port of ``rgc_slam_tpu/run.py`` (the ``roslaunch rgc_slam
run.launch`` equivalent).

    python -m rgc_slam_tpu_torch.run --log seq.slog --out-dir results/
    python -m rgc_slam_tpu_torch.run --kitti path/to/sequences/00/velodyne --no-imu
    python -m rgc_slam_tpu_torch.run --synthetic 100 --out-dir results/ --device cpu

Processes a sweep source through the full SLAM engine on ``--device``
(default ``cuda``; there is no fallback to the CPU), dumps TUM trajectories
(odometry + mapped), the global map PCD, a metrics JSONL and the per-scan
timing: the same flags and the same output files as the JAX CLI, plus
``--device`` and ``--no-trace``.  ``timing.json`` also holds, under
``trace``, ``utils.profiling.tracer``'s summary of the run's calls: each
host span's ms and each stage's device ms (``--no-trace`` leaves it out).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

from .config import SlamConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="rgc-slam-tpu runner (PyTorch port)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--log", help="sweep-log file (runtime/sweeplog format)")
    src.add_argument("--bag", help="rosbag v2.0 file (PointCloud2 + Imu)")
    src.add_argument("--kitti", help="KITTI velodyne directory")
    src.add_argument("--synthetic", type=int, metavar="N", help="run N synthetic scans")
    ap.add_argument("--cloud-topic", default="/velodyne_points")
    ap.add_argument("--imu-topic", default="/mynteye/imu/data_raw")
    ap.add_argument("--out-dir", default="slam_out")
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--n-scans-sensor", type=int, metavar="N", default=0,
                    help="sensor beam count (16/32/64); sets the ring "
                         "bookkeeping and ground tables (default 16)")
    ap.add_argument("--imu-cov-mode", choices=["reference", "preint"], default=None,
                    help="DeltaR factor weight source: the reference's "
                         "hardcoded constants, or the propagated 15-dim "
                         "preintegration covariance (ops/imu)")
    ap.add_argument("--no-ground", action="store_true")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--localize", metavar="CKPT",
                    help="localization mode: restore a prior-map checkpoint")
    ap.add_argument("--save-ckpt", metavar="DIR", help="save final state")
    ap.add_argument("--dump-frames", action="store_true",
                    help="write each deskewed scan as a world-frame PCD "
                         "(ref per-frame dumps, RGC_odometer.cpp:1353-1354)")
    ap.add_argument("--viz", action="store_true",
                    help="write viewer.html (map + trajectory + loop edges)")
    ap.add_argument("--viz-every", type=int, metavar="N", default=0,
                    help="rewrite viewer.html every N scans with "
                         "auto-refresh (live rviz stand-in)")
    ap.add_argument("--fleet", type=int, metavar="B", default=0,
                    help="run B SLAM instances on the device (vmapped "
                         "fleet); the source stream is replicated to every "
                         "robot")
    ap.add_argument("--chunk", type=int, metavar="C", default=1,
                    help="advance C scans per call (buffered replay; "
                         "per-scan budget timing is then per-chunk)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda; pass "
                         "cpu to run on the CPU)")
    ap.add_argument("--no-trace", action="store_true",
                    help="record no spans, stage times or LM counts "
                         "(utils.profiling.tracer; timing.json's trace)")
    return ap


def _overrides(args) -> dict:
    overrides = {}
    if args.no_imu:
        overrides["use_imu"] = False
    if args.imu_cov_mode:
        overrides["imu_cov_mode"] = args.imu_cov_mode
    if args.n_scans_sensor:
        overrides["n_scans"] = args.n_scans_sensor
        if args.n_scans_sensor > 32:
            # no low-ring ground-elevation table for 64-beam sensors (ring 0
            # is the highest beam): SlamConfig.expected_ground_ranges raises
            overrides["use_ground"] = False
    if args.no_ground:
        overrides["use_ground"] = False
    if args.no_loop:
        overrides["loop_closure_enable"] = False
    if args.localize:
        overrides["map_update"] = False
    return overrides


def _source(args, overrides: dict, device):
    """(config, iterator of {"cloud", "imu", "stamp"} on ``device``)."""
    from .io.convert import cloud_from_arrays, imu_from_interval

    if args.kitti:
        from .io.kitti import KittiSequence, kitti_config

        cfg = kitti_config(**overrides)
        return cfg, iter(KittiSequence(args.kitti, cfg, device=device))
    cfg = SlamConfig(**overrides)
    if args.bag:
        # the reference's front door: bag replay (README.md:40-52), parsed in
        # pure Python (io/rosbag.py) with no ROS installation
        from .io.rosbag import scan_stream

        def gen():
            for s in scan_stream(args.bag, args.cloud_topic, args.imu_topic, cfg.n_scans,
                                 cfg.scan_period):
                mask = np.ones(len(s["xyz"]), bool)
                yield {
                    "cloud": cloud_from_arrays(s["xyz"], s["intensity"], s["ring"],
                                               s["rel_time"], mask, cfg.max_points, device),
                    "imu": imu_from_interval(s["imu_t"], s["imu_acc"], s["imu_gyr"],
                                             cfg.max_imu, device),
                    "stamp": s["stamp"],
                }
    elif args.log:
        from .runtime.loader import SweepLogReader

        reader = SweepLogReader(args.log, cfg.max_points, cfg.max_imu)

        def gen():
            for s in reader:
                m = s["imu_mask"]
                yield {
                    "cloud": cloud_from_arrays(s["xyz"], s["intensity"], s["ring"],
                                               s["rel_time"], s["mask"], cfg.max_points, device),
                    "imu": imu_from_interval(s["imu_t"][m], s["imu_acc"][m], s["imu_gyr"][m],
                                             cfg.max_imu, device),
                    "stamp": s["stamp"],
                }
            reader.close()
    else:
        from .io import synthetic
        from .io.convert import cloud_from_scan_dict

        seq = synthetic.generate_sequence(
            n_scans=args.synthetic + 1, n_azimuth=900, seed=0,
            extent=30.0, radius=12.0, closes_loop=False, speed=2.0,
        )

        def gen():
            for k in range(len(seq["scans"])):
                t_imu, acc, gyr = seq["imu"][k]
                yield {
                    "cloud": cloud_from_scan_dict(seq["scans"][k], cfg, device),
                    "imu": imu_from_interval(t_imu, acc, gyr, cfg.max_imu, device),
                    "stamp": seq["stamps"][k],
                }
    return cfg, gen()


def _run_fleet(args, cfg: SlamConfig, feed, device):
    """B vmapped robots on one device (``parallel/fleet.py``), each fed the
    source stream; writes ``fleet_metrics.jsonl`` and
    ``fleet_final_poses.txt``."""
    from .models.mapping import COMPACT_MARGIN
    from .models.slam import make_chunk_step
    from .parallel import fleet
    from .types import tree_map
    from .utils.profiling import Metrics, synchronize

    # unsupported flag combinations fail instead of being ignored: fleet
    # mode has no per-frame dump / viz / checkpoint
    for flag, name in [
        (args.dump_frames, "--dump-frames"), (args.viz, "--viz"),
        (args.viz_every, "--viz-every"), (args.save_ckpt, "--save-ckpt"),
        (args.localize, "--localize"),
    ]:
        if flag:
            raise SystemExit(f"{name} is not supported with --fleet")

    # per-robot inline compaction would run its branch for every robot
    # whenever one needs it (fleet.compact_fleet): eviction runs per step
    cfg = dataclasses.replace(cfg, inline_compaction=False)
    B = args.fleet
    C = max(args.chunk, 1)
    # loop closure + PGO run vmapped on the SlamSystem cadence; their
    # compaction is loop-aware, so the loop path does not also run
    # fleet.compact_fleet
    run_loops = cfg.loop_closure_enable and cfg.map_update
    states = fleet.fleet_init(cfg, B, device)
    if run_loops:
        # make_fleet_chunk_step fires the loop step per scan whenever a
        # chunk boundary would delay it past the eviction headroom, so the
        # only hard bound here is on the cadence itself
        if cfg.loop_cadence > COMPACT_MARGIN:
            raise SystemExit(
                f"loop_cadence {cfg.loop_cadence} exceeds the keyframe-eviction "
                f"headroom (COMPACT_MARGIN={COMPACT_MARGIN})"
            )
        loop_states = fleet.fleet_loop_init(cfg, B, device)
        counter = torch.tensor(0, dtype=torch.int32)   # read by the host each chunk
        fchunk_l = fleet.make_fleet_chunk_step(cfg, C)
        fstep1_l = fchunk_l if C == 1 else None        # trailing partial chunk
    else:
        # loop-less fleets compact inside the step (fleet_step_compacting)
        fstep = functools.partial(fleet.fleet_step_compacting, cfg=cfg)
        if C > 1:
            fchunk = make_chunk_step(fstep, C)
    metrics = Metrics()
    n = 0
    outs = None
    buf = []
    t0 = time.perf_counter()

    def batch(item):
        clouds, imus = tree_map(lambda a: a.expand(B, *a.shape).contiguous(),
                                (item["cloud"], item["imu"]))
        return clouds, imus, torch.full((B,), item["stamp"], dtype=torch.float32, device=device)

    for item in feed:
        buf.append(batch(item))
        if len(buf) < C:
            continue
        flat = [x for triple in buf for x in triple]
        if run_loops:
            states, loop_states, counter, chunk_outs = fchunk_l(states, loop_states, counter,
                                                                *flat)
            outs = chunk_outs[-1]
        elif C > 1:
            states, chunk_outs = fchunk(states, *flat)
            outs = chunk_outs[-1]
        else:
            states, outs = fstep(states, *buf[0])
        n += len(buf)
        buf = []
        if n % 50 < C:
            fit = outs.fitness.float()
            print(f"  scan {n}: fleet fitness med={float(fit.quantile(0.5)):.4f} "
                  f"max={float(fit.max()):.4f}")
    for triple in buf:                                  # trailing partial chunk
        if run_loops:
            if fstep1_l is None:
                fstep1_l = fleet.make_fleet_chunk_step(cfg, 1)
            states, loop_states, counter, outs1 = fstep1_l(states, loop_states, counter, *triple)
            outs = outs1[-1]
        else:
            states, outs = fstep(states, *triple)
        n += 1
    if outs is None:
        print("fleet: no scans in the source (check topic names / file)")
        return
    synchronize(device)
    wall = time.perf_counter() - t0
    tm = outs.t_map.cpu().numpy()
    metrics.log(n, robots=B, scans_per_sec=round(n * B / wall, 1),
                cross_robot_spread_m=float(np.abs(tm - tm[:1]).max()))
    metrics.dump(os.path.join(args.out_dir, "fleet_metrics.jsonl"))
    np.savetxt(os.path.join(args.out_dir, "fleet_final_poses.txt"), tm)
    print(f"fleet {B}x{n} scans in {wall:.1f}s ({n * B / wall:.0f} scans/sec) -> {args.out_dir}")


def _restore_prior_map(path: str, cfg: SlamConfig, device):
    """The mapping state of a ``SlamSystem.save`` checkpoint, which is
    ``(state,)`` or ``(state, loop_state)``."""
    from .models.loop import LoopState
    from .models.slam import SlamState
    from .utils.checkpoint import read_manifest, restore

    like = (SlamState.init(cfg, device),)
    if read_manifest(path)["loop_state"]:
        like += (LoopState.init(cfg, device),)
    restored, _ = restore(path, like, device)
    return restored[0].mapping


def _chunked(feed, size: int):
    """Group the stream into size-C lists; a final partial group is emitted
    as singletons (the ``process`` path)."""
    buf = []
    for item in feed:
        buf.append(item)
        if len(buf) == size:
            yield buf
            buf = []
    for item in buf:
        yield [item]


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the engine runs on the card unless "
                           "--device cpu is given")

    from .io.export import global_map, write_pcd
    from .models.slam import SlamSystem
    from .utils import math3d as m3
    from .utils.profiling import Metrics, StageTimer, tracer

    overrides = _overrides(args)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg, feed = _source(args, overrides, device)
    if args.fleet:
        return _run_fleet(args, cfg, feed, device)

    system = SlamSystem(cfg, chunk=args.chunk, device=device, trace=not args.no_trace)
    t_start = time.perf_counter_ns()
    if args.localize:
        system.state = system.state.replace(
            mapping=_restore_prior_map(args.localize, cfg, device))

    timer = StageTimer(budget_ms=100.0 * args.chunk)
    metrics = Metrics()
    n = 0
    frame_sink = None
    if args.dump_frames:
        # native PCD writer: frames queue into a bounded ring drained by a
        # C++ thread, so disk writes never stall the replay loop
        from .runtime.loader import PcdSink

        frame_sink = PcdSink(os.path.join(args.out_dir, "frames"))

    try:
        for items in _chunked(feed, max(args.chunk, 1)):
            # the stage synchronizes the device, so timing.json measures the
            # step's work and the reference's >100 ms budget warning
            # (RGC_odometer.cpp:1360-1361) can fire
            with timer.stage("scan", device):
                if len(items) == system.chunk and system.chunk > 1:
                    outs = system.process_chunk(
                        [(i["cloud"], i["imu"], i["stamp"]) for i in items])
                else:
                    outs = [system.process(i["cloud"], i["imu"], i["stamp"]) for i in items]
            out = outs[-1]
            for kk, o in enumerate(outs):
                metrics.log(n + kk, fitness=float(o.fitness), n_corr=int(o.n_corr),
                            kf_added=bool(o.kf_added))
            if frame_sink is not None:
                for kk, o in enumerate(outs):
                    world = m3.quat_rotate(o.q_map[None, :], o.full_xyz) + o.t_map[None, :]
                    frame_sink.push(n + kk, world[o.full_mask].cpu().numpy())
            n_prev = n
            n += len(outs)
            # boundary-crossing test so --chunk C not dividing --viz-every
            # still refreshes at the requested rate
            if args.viz_every and n // args.viz_every > n_prev // args.viz_every:
                from .io.viz import write_viewer

                write_viewer(os.path.join(args.out_dir, "viewer.html"), system, cfg,
                             refresh_s=2.0)
            if n % 50 == 0:
                print(f"  scan {n}: t={out.t_map.cpu().numpy().round(2)}")
    finally:
        # always drain and join the native writer thread: an exception
        # mid-loop must not leak it or drop queued frames
        if frame_sink is not None:
            errs = frame_sink.close()
            if errs:
                print(f"[rgc-slam-tpu] PCD sink: {errs} write errors")

    # ---- outputs (the reference's pose_evo.txt / PCD surface) ----
    system.dump_tum(os.path.join(args.out_dir, "pose_evo.txt"), "map")
    system.dump_tum(os.path.join(args.out_dir, "odometry_pose_evo.txt"), "odom")
    pts, conf = global_map(system.state.mapping, cfg)
    if len(pts):
        write_pcd(os.path.join(args.out_dir, "global_map.pcd"), pts, conf)
    if args.viz or args.viz_every:
        from .io.viz import write_viewer

        write_viewer(os.path.join(args.out_dir, "viewer.html"), system, cfg)
    metrics.dump(os.path.join(args.out_dir, "metrics.jsonl"))
    timing = timer.summary()
    if system.trace:
        timing["trace"] = tracer.summary(since_ns=t_start)
    with open(os.path.join(args.out_dir, "timing.json"), "w") as f:
        json.dump(timing, f, indent=2)
    if args.save_ckpt:
        system.save(args.save_ckpt)
    print(f"processed {n} scans -> {args.out_dir}")


if __name__ == "__main__":
    main()
