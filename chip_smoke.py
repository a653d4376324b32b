"""Smoke test of the PyTorch port on one NVIDIA GPU: build, kernel check, main paths.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and the exit code is
not 0):

1. device: requires CUDA (no CPU fallback) and prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the kNN kernel (rgc_slam_tpu_torch/csrc/knn.cu) with nvcc
   and prints registers and spills per k from ``-Xptxas -v``; the sweep-log
   library (rgc_slam_tpu_torch/runtime/sweeplog.cc) builds with g++ meanwhile;
3. kernel vs plain: the kernel against ``knn_plain`` on the card, at the
   mapping association's shapes (512 x 8192 and 2048 x 32768, k=5), at the
   loop closure's (the loop-ICP 1-NN, 2560 x 16384 k=1, and the GICP /
   normals self-kNN, 16384 x 16384 and 2560 x 2560 k=20 with 10% of the
   points masked),
   k=1, k=20 with a ragged N, all-masked points and exact ties; then split
   invariance: one chunk, the planned split and a ragged split give
   bit-identical results at the five path shapes (the mapping shapes at
   k=5 and k=20);
3b. timing: device time per call of the kernel and of the plain version,
   in turns, at the five path shapes, each beside its bound (the larger of
   8 float32 operations per pair with an unmasked point at 67 TFLOP/s and
   the bytes read and written at 3.35 TB/s).  If an earlier version of the
   kernel is staged at ``rgc_slam_tpu_torch/_build/knn_prev.cu`` (for
   example ``git show <commit>:rgc_slam_tpu_torch/csrc/knn.cu``, whose
   entry point takes no split), it is built beside the kernel and timed in
   turns with it at the mapping shapes;
4. main path without loops: ``SlamSystem.process`` over a 10-scan
   synthetic VLP-16 sequence (16 x 1800 points) at
   ``SlamConfig(loop_closure_enable=False)`` on cuda:0, with the kernel's
   launch count read around the run, finite poses and the trajectory ATE
   held against the JAX package's ATE on the same sequence and config; then
   the census of host syncs (``SyncCensus``): the last scan once more from a
   copy of its state under ``torch.cuda.set_sync_debug_mode("warn")``, its
   syncs printed by port source line and in total, with a control (one
   ``bool()`` of a device tensor) that must be counted exactly once; and
   whether ``utils.math3d.eigh_or_nan`` and ``svd_or_nan`` make the host
   wait for the device (``blocking_probe``: the call queued behind a
   spinning kernel);
5. main path with loops: ``SlamSystem(SlamConfig(**LOOP_CFG))`` (the
   default config, loops on, point-to-point loop ICP) over a 140-scan
   closed-loop sequence at the same width; reads each loop step's flags
   from ``SlamSystem.loop_info``; asserts finite unit poses, at least one
   accepted loop, kNN launches per scan of 4 x ``map_opt_iterations``
   plus 0 or ``loop_icp_iterations`` + 1 (the latter at least once), the
   first accepted loop's scan, history keyframe and constraint against the
   JAX package's, that loop's 4-DoF residual cut by its PGO, and the
   trajectory and post-PGO keyframe ATEs within their gates; prints ms per
   scan, and per loop step (with and without ICP) and per PGO, each run
   once more alone from a copy of its inputs; the census of the first
   accepting loop step (ICP and PGO) replayed from a copy of its inputs;
5b. the GICP and point-to-plane loop ICP: ``loop_closure_step`` once
   each with ``loop_icp_method`` "gicp" and "plane" from the state that
   phase 5's first accepting loop step started from; finite outputs and
   the kNN launches at each shape;
6. fleet without loops: ``parallel.fleet.fleet_step_compacting`` on 128
   robots at the JAX package's FLEET_CONFIG (bench.py) with loops off, 8
   synthetic worlds of 900-azimuth sweeps tiled over the robots, 12 steps
   under ``strict_vmap``: 8 kNN launches per fleet step whatever the number
   of robots, robots of one world within FLEET_SPREAD_GATE of each other,
   robot 0 against one robot alone over 3 scans, every robot's ATE against
   the JAX fleet's on its world (``chip_smoke_reference.py --fleet``); prints
   wall ms per fleet step and scans/s; the census of the last fleet step
   replayed from a copy of its state;
6b. fleet loop step on mixed robots: phase 5's first loop steps without a
   candidate, with a rejected one and with an accepted loop, their inputs
   stacked into three robots through one ``fleet_loop_step``: each robot's
   LoopInfo flags and candidate as its single-stream step's, its fitness
   within 1e-3 relative of the single stream's, the accepted robot's
   constraint and keyframe poses within 1e-4 m (yaw 1e-5 rad) of the
   single stream's, and its PGO within 1e-4 m of the same solve run alone;
6c. fused fleet with loops: ``make_fleet_chunk_step`` at FLEET_CONFIG with
   loops on, 128 robots, 12 scans in chunks of 4: the loop step fires at the
   end of the chunk that holds each cadence boundary (one inside a chunk);
   prints ms per chunk;
7. the CLI on the card: phase 4's first CLI_SCANS scans written to a sweep
   log with the port's ``runtime.loader.write_sequence`` and run through
   ``rgc_slam_tpu_torch.run.main`` in this process (``--log --no-loop
   --dump-frames --save-ckpt``, default config, device cuda): exactly 8 kNN
   launches a scan at shapes phase 3b timed, finite unit poses in
   ``pose_evo.txt``, ``timing.json``'s scan count, one frame PCD a scan and
   the trajectory ATE against ``ATE_JAX_CLI``; then ``--localize`` on that
   checkpoint over the log's first CLI_SIDE_SCANS scans (the frozen map's
   ``global_map.pcd`` holds the mapping run's points) and ``--bag`` over
   the same scans in an lz4-chunked bag written with the port's
   ``BagWriter`` (8 launches a scan, finite poses); prints ms/scan from
   ``timing.json``.
8. sharded step on the card: ``parallel.distributed.run_ranks`` starts
   SHARD_RANKS gloo ranks (``tools.smoke_ranks.shard_rank``: a rank never
   runs this script) that share cuda:0 as a dp=1 x sp=2 mesh and load
   the library phase 2 built (a rank never builds it); each runs
   ``fleet.make_distributed_step`` on one robot at
   ``SlamConfig(loop_closure_enable=False, sp_features=True)`` over phase
   4's first SHARD_SCANS scans: the ranks' poses bit-equal, within max(5e-3
   m, twice the single stream's own deviation when those scans are
   perturbed by 1e-7) of phase 4's poses, exactly 8 kNN launches a scan on
   each rank at the sharded shapes (counted in the ranks); prints ms/scan
   per rank (two ranks sharing one card, not a scaling number);
8b. rbf covariances: ``SlamConfig(loop_closure_enable=False,
   cov_estimation="rbf")`` over the same scans on one process, ATE against
   ``ATE_JAX_RBF`` (``chip_smoke_reference.py --rbf``).
9. the registration library: ``ops.gicp.gicp_mp_register`` and
   ``ndt_register`` (d2d and p2d, resolution 1.0) at the default
   ``SlamConfig()`` on tests/test_gicp_variants.py's scene (two walls and
   the ground, 1 cm noise) drawn at the loop ICP's widths: a 2560-point
   source and a 16384-point target drawn apart from the same scene and
   moved by a known pose (``registration_scene``).  Each result within
   max(5e-3, 2 x JAX's own deviation under 1e-7-perturbed inputs) of the
   JAX package's on the same inputs (``REG_JAX``,
   ``chip_smoke_reference.py --registration``) with the same
   correspondence and iteration counts, within the JAX test's limits of
   the true pose, and the kNN launches exactly per shape: for GICP-MP one
   each of the two k=20 self-searches, ``iterations`` + 1 fusion searches
   at k=16 and one 1-NN; none for NDT.  Each runs twice: the second call
   is timed and bit-equal to the first;
9b. the port against the numpy oracles: ``utils.parity_gates`` (the gates
   of tests/test_parity_oracles.py: ground fit, complementary filter,
   VGICP linearize, the LM λ schedule, the FourDOF residual and the PGO,
   the two-pose mapping solve, the odometry fusion, rel_time and deskew)
   with the port's stages on the card and ``utils.parity``'s oracles on
   the host; the loop-ICP gate, whose oracle is ~20 s of host numpy, runs
   in the CPU tests only.
10. the evaluation programs (``rgc_slam_tpu_torch.tools``):
   ``eval.run_sequence`` over the first EVAL_SCANS scans of ``eval.py``'s
   quick config 4 (64-beam, lidar-only, 65536-point caps) and config 3 (the
   degraded corridor), each ATE within max(1.05 x JAX + 0.01 m, JAX's worst
   1e-7-perturbed run + 0.01 m) of the JAX harness on the same scans
   (``EVAL_JAX``, ``chip_smoke_reference.py --eval``); ``eval_stages``'
   single-stream rows over EVAL_STAGE_REPS calls a stage (wall ms,
   ``torch.profiler`` device ms and kernel counts, all finite; features and
   odometry launch no more kernels than the full step); ``eval_pgo.run_case``
   at K=512: the ATE after the PGO below the ATE before, within max(1e-3 m,
   2 x JAX's own deviation) of JAX's (``PGO_JAX``).
11. the root programs' ports: ``tools.graft_entry.entry()``'s step once
   at ENTRY_CONFIG (finite poses, 8 kNN launches);
   ``dryrun_multichip(ENTRY_RANKS)``, dp=2 x sp=2 gloo ranks sharing
   cuda:0 over ENTRY_STEPS - 1 scans, the sharded trajectory within 5e-3 m
   of the one-process fleet (8 launches a step on each rank); and
   ``tools.bench.main`` at BENCH_CUT (8 robots): one JSON line that parses,
   every rate finite and positive, platform "gpu", the card's name and
   power limit, 8 launches per fleet step.

Phase 3 also holds the batched launch (B = 1, 3 and 128 lanes at the
fleet's shapes, ragged masks per lane) to one-lane launches bit for bit
and to the batched plain version, and 3b times it at 128 lanes; it holds
the kernel to ``knn_plain`` bit for bit on NaN inputs (NaN in masked
points, in unmasked points, in a query, and fewer finite points than k),
and 3b times phase 8's sharded shapes (256 x 8192 and 1024 x 32768, k=5),
phase 9's GICP-MP fusion search (2560 x 16384, k=16; phase 3 also holds it
bit for bit to ``knn_plain`` on exact grid coordinates), phase 10's
association at eval.py's BASE (512 x 4096 and 2048 x 16384, k=5), and the
searches of the evaluation programs that phase 10 does not run:
``tools.eval_longrun`` (256 x 1024 and 1024 x 4096 at k=5, 1280 x 8192 at
k=1) and ``tools.eval``'s fleets (64 lanes at FLEET_CONFIG's mapping shapes,
4 lanes at BASE's and its loop ICP's; phase 3 checks them as the batched
cases), and phase 11's: ENTRY_CONFIG's association (128 x 1024, and 512 x
4096 as phase 10's), the dry run's sp halves (64 x 1024, 256 x 4096), its
reference fleet at 2 lanes and the bench's 8 lanes at FLEET_CONFIG's
mapping shapes (checked as batched cases).  The kNN
wrapper counts its launches at each shape (lanes, queries, points, k); the
counts are set to 0 before each path phase (4 to 11) and read after it,
and the kernels line reports them per shape and in sum.
The census's totals per unit are printed once more after phase 11.  The
line before the last is the card's name and power limit, the one before
it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  The full compiler report and every
number go to ``chiprun_out/`` (``knn_ptxas.txt``, ``chip_smoke.json``).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import io
import json
import linecache
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from collections import Counter

import numpy as np

# The JAX package's trajectory ATE (map frame, metres) on the sequence and
# config of phase 4 (chip_smoke_reference.py --main: slam_step under
# jax.jit, JAX 0.9.0 on the CPU, x86-64, SlamConfig(loop_closure_enable=
# False), SEQ_ARGS, utils.evaluation.ate_rmse on t_map).  Phase 4 ran 30
# scans (n_scans=31, ATE_JAX 0.019438966313960963 m), then 15 (n_scans=16,
# 0.026916166591930656 m), as the fleet phases needed its time.
ATE_JAX = 0.03160757833403754
ATE_GATE = "1.05 * ATE_JAX + 0.01"

SEQ_ARGS = dict(n_scans=11, n_azimuth=1800, seed=5, extent=18.0, radius=8.0, noise=0.004,
                motion_distortion=True, closes_loop=False, speed=2.0)

# Phase 5: the default SlamConfig (loops on, point-to-point loop ICP, every
# capacity at its default) but for the one field below, over a closed-loop
# synthetic VLP-16 sequence shaped like tests/test_loop.py's closed circle.
LOOP_SEQ_ARGS = dict(n_scans=141, n_azimuth=1800, seed=11, extent=22.0, radius=9.0, noise=0.004,
                     motion_distortion=True, closes_loop=True, laps=1.25)
LOOP_CFG = dict(
    # the synthetic clouds are sparser than a real sensor's, so the
    # point-to-point fitness of a true revisit sits at 0.13-0.16 on this
    # sequence, above the reference's 0.1 gate (tests/test_loop.py:131
    # raises it the same way)
    loop_fitness_thresh=0.15,
)

# The JAX package on phase 5's sequence and config (chip_smoke_reference.py,
# JAX 0.9.0 on the CPU, x86-64): trajectory ATE of t_map, post-PGO keyframe
# ATE (m) and accepted loops, as generated (LOOP_JAX; loops accepted at
# scans 100, 130 and 140) and the worst of seven runs with every scan's
# coordinates perturbed by 1e-7 relative (LOOP_JAX_WORST; --perturb 1-7,
# each accepting at scans 100 and 110: ATE 0.4112-0.4184 m, keyframe ATE
# 0.3995-0.4082 m).  The reference is chaotic in float32: its fitness at
# scan 110 is 0.1455-0.1521 against the 0.15 gate, and an earlier run of
# the unperturbed sequence on the same CPU accepted at 100 and 110 (ATE
# 0.4166 m, keyframe ATE 0.4068 m).
LOOP_JAX = dict(ate=0.3937363827171968, kf_ate=0.3433525322535027, loops=3)
LOOP_JAX_WORST = dict(ate=0.41837069508417724, kf_ate=0.4082435922108982)
LOOP_GATE = "max(1.05 * LOOP_JAX + 0.01, LOOP_JAX_WORST + 0.01)"
# The ATE gates alone would pass a broken loop path: the JAX package with
# the loop step off (--control no-loops) reaches ATE 0.4179 m and keyframe
# ATE 0.4190 m on this sequence.  So the first accepted loop is held to the
# JAX package's (same scan and history keyframe; loop_t and loop_yaw within
# the gates below, set from the spread of the perturbed runs), and its PGO
# must cut that loop's 4-DoF residual to at most PGO_GAIN of what it was.
# The JAX package's first accepted loop (chip_smoke_reference.py, the
# unperturbed run; every perturbed run accepts it at the same scan and on
# the same keyframes), and gates of twice the largest deviation of the
# perturbed runs from it (loop_t 0.06506 m, loop_yaw 9.586e-4 rad).
FIRST_LOOP_JAX = dict(scan=100, loop_i=49, loop_j=6,
                      loop_t=[-6.010218620300293, 6.587498664855957, -0.6615163683891296],
                      loop_yaw=-1.6687355041503906)
FIRST_LOOP_GATE = dict(t=2 * 0.06505835056304932, yaw=2 * 0.000958561897277832)
PGO_GAIN = 0.5

# Phase 6: the JAX package's throughput deployment, a fleet of FLEET_B
# robots on one device (bench.py: FLEET_CONFIG, FLEET_B = 128, 900-azimuth
# sweeps of 8 worlds tiled over the robots); the port's copy of the config
# is ``rgc_slam_tpu_torch.config.FLEET_CONFIG``, run with loops off.
FLEET_B = 128
FLEET_SEEDS = tuple(range(1, 9))
FLEET_SEQ_ARGS = dict(n_scans=13, n_azimuth=900, extent=30.0, radius=12.0, noise=0.01,
                      closes_loop=False, speed=2.0)
# The JAX package's fleet (chip_smoke_reference.py --fleet: fleet_step_compacting
# under jax.jit, JAX 0.9.0 on the CPU, x86-64, one robot per world; robots
# are independent, so tiling the worlds over FLEET_B robots changes
# nothing): each world's trajectory ATE (m) as generated, and the worst of
# seven runs with every scan's coordinates perturbed by 1e-7 relative
# (--perturb 1-7).
FLEET_JAX = (0.045210906878711314, 0.049351965670623325, 0.033554838126707176,
             0.027580677730342663, 0.031044874675535114, 0.031072336955558333,
             0.04231904417075249, 0.04080908178388382)
FLEET_JAX_WORST = (0.04576455756720348, 0.05027471101766105, 0.03544266968647557,
                   0.028285992141086447, 0.031834830127204866, 0.03094182098814244,
                   0.042918004261808536, 0.041255760078673154)
FLEET_GATE = "max(1.05 * FLEET_JAX + 0.01, FLEET_JAX_WORST + 0.01)"
# Robots of one world are repeated runs of one robot.  With the voxel
# segment sums in float64 they stayed 7.4e-6 m apart on the card, until
# rgc_slam_tpu_torch/tools/lane_rounding.py found the first function that
# split identical lanes, the plane fit's batched QR, whose k-row sums are
# now term by term: held within 1e-4 m.  Robot 0 against one robot alone:
# tests/test_torch_slam.py's early-scan gate.
FLEET_SPREAD_GATE = 1e-4
FLEET_SINGLE_SCANS = 3
FLEET_SINGLE_GATE = 5e-3
# Phase 6c: loops on, chunks of FLEET_CHUNK scans (the cadence boundary at
# scan 10 falls inside the chunk of scans 9-12); 12 scans, not 20, keep the
# script inside its time with phases 8 and 8b.
FLEET_CHUNK = 4
FLEET_LOOP_SCANS = 12
# Phase 6b: the accepted robot's constraint and keyframe poses are held to
# the single stream's within the PGO's own gate below (1e-4 m; 1e-5 rad,
# 1e-4 m at 10 m, for the yaw).  A vmapped loop ICP sums in other orders
# than a single one (batched reductions, the batched 3x3 SVD), which 30
# iterations of 1-NN matching amplify to ~5e-4 m in float32; the ICP sums
# and solves in float64 and rounds once (models/loop.icp_point2point).
FLEET_LOOP_GATE = dict(t=1e-4, yaw=1e-5, kf_t=1e-4)

# Phase 7: the CLI over phase 4's first CLI_SCANS scans as a sweep log, and
# over its first CLI_SIDE_SCANS scans localized and as a bag.  The JAX CLI's
# trajectory ATE (map frame, metres) on the same log (chip_smoke_reference.py
# --cli: rgc_slam_tpu.run.main --log --no-loop, JAX 0.9.0 on the CPU,
# x86-64, utils.evaluation.ate_rmse of pose_evo.txt against the sequence's
# ground truth).
CLI_SCANS = 8
CLI_SIDE_SCANS = 3
ATE_JAX_CLI = 0.03479721692435601
CLI_GATE = "1.05 * ATE_JAX_CLI + 0.01"

# Phase 8: the sharded step over phase 4's first SHARD_SCANS scans on
# SHARD_RANKS ranks of one card (dp=1, sp=2), held to phase 4's single
# stream within max(SHARD_GATE, twice the single stream's own deviation
# when those scans are perturbed by 1e-7 relative; SHARD_PERTURB seeds);
# 5e-3 m is __graft_entry__.py:141-145's multichip gate.
SHARD_SCANS = 5
SHARD_RANKS = 2
SHARD_GATE = 5e-3
SHARD_PERTURB = (1, 2)
SHARD_TIMEOUT_S = 300
# Phase 8b: the same scans at SlamConfig(loop_closure_enable=False,
# cov_estimation="rbf") on one process.  The JAX package's ATE (m) on them
# (chip_smoke_reference.py --rbf, JAX 0.9.0 on the CPU, x86-64).
ATE_JAX_RBF = 0.04330920295177962
RBF_GATE = "1.05 * ATE_JAX_RBF + 0.01"

# Phase 9: the registration library on tests/test_gicp_variants.py's scene
# at the loop ICP's widths (max_kf_corner + max_kf_surf source points,
# max_loop_submap_points target points), the target moved by REG_YPR /
# REG_T.  REG_JAX is the JAX package on the same inputs
# (chip_smoke_reference.py --registration, JAX 0.9.0, CPU): pose, counts,
# and "dev", its own largest pose change (quaternion up to sign, t) over
# runs with every coordinate scaled by 1 + 1e-7 N(0, 1) (seeds 1-3).
REG_SRC, REG_TGT, REG_SEED = 2560, 16384, 42
REG_YPR = (0.05, 0.02, -0.03)
REG_T = (0.3, -0.2, 0.1)
REG_FLOOR = 5e-3                 # PERF.md §2's rule: max(5e-3, 2 x JAX's own deviation)
REG_TRUTH_T = {"gicp_mp": 0.03, "ndt d2d": 0.1, "ndt p2d": 0.1}   # tests/test_gicp_variants.py
REG_METHODS = {"gicp_mp": ("gicp_mp_register", {}),
               "ndt d2d": ("ndt_register", {"resolution": 1.0, "distance_mode": "d2d"}),
               "ndt p2d": ("ndt_register", {"resolution": 1.0, "distance_mode": "p2d"})}
REG_JAX = {
    "gicp_mp": dict(
        q=[0.9995216727256775, -0.015118763782083988, 0.009555304422974586, 0.02523040771484375],
        t=[0.30137205123901367, -0.20067091286182404, 0.09832042455673218],
        iterations=3, n_corr=2560, dev=7.361173629760742e-06),
    "ndt d2d": dict(
        q=[0.9995699524879456, -0.015061200596392155, 0.009552644565701485, 0.023276787251234055],
        t=[0.27448877692222595, -0.18209707736968994, 0.09814827889204025],
        iterations=3, n_corr=183, dev=2.384185791015625e-07),
    "ndt p2d": dict(
        q=[0.9995236992835999, -0.015056395903229713, 0.009548492729663849, 0.025188790634274483],
        t=[0.3012622892856598, -0.20089347660541534, 0.09731088578701019],
        iterations=4, n_corr=2560, dev=1.4901161193847656e-08),
}
# Phase 9b: every gate of utils.parity_gates but the loop ICP's (its oracle
# is ~20 s of host numpy; the CPU tests run it)
ORACLE_GATES = ("ground_fit", "complementary_filter", "vgicp_linearize", "lm_schedule",
                "fourdof_residual", "pgo_solve", "mapping_solve", "odometry_fusion", "rel_time",
                "deskew")
# Phase 10: the evaluation programs (rgc_slam_tpu_torch.tools).  The first
# EVAL_SCANS scans of eval.py's quick config-4 (64-beam, lidar-only,
# 65536-point caps) and config-3 (degraded corridor) sequences through
# tools.eval.run_sequence; EVAL_JAX is the JAX harness's ATE (eval.py's
# run_sequence) on the same scans and config, EVAL_JAX_WORST its worst over
# 1e-7-perturbed scans (chip_smoke_reference.py --eval [--perturb 1..3],
# JAX 0.9.0, CPU).  PGO_JAX: eval_pgo.py's K=512 case, its post-PGO ATE and
# "dev", its own largest change over keyframe positions scaled by
# 1 + 1e-7 N(0, 1) (seeds 1-3).
EVAL_SCANS = {"4": 4, "3": 6}
EVAL_JAX = {"4": 0.1011, "3": 0.1115}
EVAL_JAX_WORST = {"4": 0.1048, "3": 0.1115}          # --perturb 1, 2, 3
EVAL_GATE = "max(1.05 * EVAL_JAX + 0.01, EVAL_JAX_WORST + 0.01)"
EVAL_STAGE_REPS = 3
EVAL_PGO_K, EVAL_PGO_CG = 512, 128
PGO_JAX = dict(ate_before=2.674080743376258, ate_after=0.04423870159845814,
               dev=7.603277166250144e-06)
PGO_FLOOR = 1e-3                 # max(1e-3 m, 2 x PGO_JAX["dev"])

# Phase 11: the ports of the root programs.  tools.graft_entry's entry()
# once and dryrun_multichip(ENTRY_RANKS) at dp=2 x sp=2 over ENTRY_STEPS
# (its drive yields one scan fewer), the ranks sharing cuda:0; tools.bench
# at BENCH_CUT (its knobs, set for the call and restored after).  The
# single stream is left to the full bench (about 1.5-2.2 s a scan), and 2
# timed steps (15 fleet steps in all) keep the phase near 110 s.
ENTRY_RANKS = 4
ENTRY_STEPS = 8
BENCH_CUT = dict(FLEET_B=8, N_TIMED=2, CHUNK=2, N_REPS=1, SKIP_SINGLE=True, SKIP_LOOPS=False)

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_DIR = os.path.join(ROOT, "rgc_slam_tpu_torch", "_build", "phase7")
MAIN_SHAPES = ("corner 512x8192 k=5", "surf 2048x32768 k=5")
# phase 8's mapping association on each of 2 sp ranks: half of each query cloud
SP_SHAPES = ("sp corner 256x8192 k=5", "sp surf 1024x32768 k=5")
LOOP_SHAPES = ("loop ICP 2560x16384 k=1", "self 16384x16384 k=20", "self 2560x2560 k=20")
# phase 9's GICP-MP fusion search: the source against the target, k=16
REG_SHAPES = ("gicp-mp fuse 2560x16384 k=16",)
# phase 10's mapping association at eval.py's BASE (and bench.py's
# BENCH_CONFIG): max_map_points 16384; and tools.eval_longrun's CFG
# (TEST_CONFIG's map, 256 + 1024 keyframe points, an 8192-point loop submap)
EVAL_SHAPES = ("base corner 512x4096 k=5", "base surf 2048x16384 k=5")
LONGRUN_SHAPES = ("longrun corner 256x1024 k=5", "longrun surf 1024x4096 k=5",
                  "longrun loop ICP 1280x8192 k=1")
# phase 11: entry()'s association at ENTRY_CONFIG (its surf search,
# 512x4096, is EVAL_SHAPES' corner) and the dry run's sp ranks' halves
ENTRY_SHAPES = ("entry corner 128x1024 k=5", "dryrun sp corner 64x1024 k=5",
                "dryrun sp surf 256x4096 k=5")
PEAK_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3


def gt_at_keyframes(kf_stamp, stamps, gt) -> np.ndarray:
    """Ground-truth position of the scan nearest each keyframe's stamp:
    what the post-PGO keyframe ATE compares the keyframe store with."""
    st = np.asarray(stamps, np.float32)
    return np.stack([gt[int(np.argmin(np.abs(st - s)))] for s in kf_stamp])


def _key(lanes: int, nq: int, n: int, k: int) -> str:
    return f"{nq}x{n} k={k}" if lanes == 1 else f"{lanes}x{nq}x{n} k={k}"


def shape_key(queries, points, k: int) -> str:
    """How the launch counts name a call's shape: "QxN k=K" for one search,
    "BxQxN k=K" for a launch of B lanes ([B, Q, 3] queries)."""
    lanes = queries.shape[0] if queries.ndim == 3 else 1
    return _key(lanes, queries.shape[-2], points.shape[-2], k)


def by_shape(counter) -> dict:
    """The wrapper's per-shape counts, keyed by ``shape_key``."""
    return {_key(*key): c for key, c in sorted(counter.items())}


def phase(name: str):
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# the census of host syncs (phases 4, 5 and 6)
# ---------------------------------------------------------------------------

SYNC_WARNING = "called a synchronizing CUDA operation"
PORT_DIR = os.path.join(ROOT, "rgc_slam_tpu_torch") + os.sep
SCRIPT = os.path.abspath(__file__)
SPIN_CYCLES = 100_000_000        # torch.cuda._sleep: 50.5 ms on an H100 80GB HBM3 at 700 W
REPLAY_GATE = 1e-5               # m: a replayed step against the run's (card runs repeat)


class SyncCensus:
    """Counts the host syncs made inside a ``with`` block, as torch's sync
    debug mode reports them: under ``torch.cuda.set_sync_debug_mode("warn")``
    every call that waits for the device through c10's copy and synchronize
    helpers warns once (``bool()``, ``.item()``, ``.cpu()``, a blocking
    host-to-device copy, ``nonzero``, ``torch.linalg``'s error check).  Each
    warning is filed under the innermost line of the port on the stack,
    else of this script.  A wait inside a library that bypasses c10
    (cuSOLVER's own) is not seen here: ``blocking_probe`` measures that."""

    def __init__(self, torch, unit: str):
        self.torch, self.unit = torch, unit
        self.sites = Counter()
        self.other = 0                     # warnings of any other kind, not shown

    def __enter__(self):
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._seen
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        return False

    def _seen(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            self.other += 1
            return
        site = script = None
        frame = sys._getframe(1)
        while frame is not None and site is None:
            path = os.path.abspath(frame.f_code.co_filename)
            if path.startswith(PORT_DIR):
                site = (path, frame.f_lineno)
            elif path == SCRIPT and script is None:
                script = (path, frame.f_lineno)
            frame = frame.f_back
        path, line = site or script or (filename, lineno)
        self.sites[(os.path.relpath(path, ROOT), line)] += 1

    @property
    def total(self) -> int:
        return sum(self.sites.values())

    def report(self) -> dict:
        """Prints the syncs of each site and the unit's total; returns them."""
        print(f"  host syncs in {self.unit}: {self.total} at {len(self.sites)} sites "
              f"(torch sync debug mode; {self.other} other warnings)")
        rows = sorted(self.sites.items(), key=lambda kv: (-kv[1], kv[0]))
        for (path, line), n in rows:
            text = linecache.getline(os.path.join(ROOT, path), line).strip()
            print(f"    {n:6d}  {path}:{line}  {text[:90]}")
        return {"unit": self.unit, "total": self.total,
                "sites": {f"{path}:{line}": n for (path, line), n in rows}}


def census_control(t) -> bool:
    """The census's control: one ``bool()`` of a device tensor, one sync."""
    return bool(t)


CONTROL_SITE = (os.path.relpath(SCRIPT, ROOT), census_control.__code__.co_firstlineno + 2)


def blocking_probe(torch, fn) -> dict:
    """Whether ``fn()`` makes the host wait for the device: a kernel that
    spins SPIN_CYCLES is queued first, then ``fn`` is called; a call that
    waits returns only once the spin has ended, one that does not returns
    at once.  Also the syncs the census sees in the call."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(SPIN_CYCLES)
    b.record()
    with SyncCensus(torch, "the probe") as census:
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = a.elapsed_time(b)
    return {"host_ms": host_ms, "spin_ms": spin_ms, "blocks": host_ms > 0.5 * spin_ms,
            "syncs_seen": census.total}


def sync_probes(torch, dev) -> dict:
    """Phase 4's probes: whether ``utils.math3d.eigh_or_nan`` (the ground
    fit's 3x3, ``ops/features.py:462``; 128 of them under the fleet's vmap)
    and ``svd_or_nan`` (the loop ICP's 3x3 Kabsch, ``models/loop.py:143``)
    wait for the device, beside a control that does (``bool()``) and one
    that does not (a matrix product)."""
    from rgc_slam_tpu_torch.utils import math3d as m3

    g = torch.Generator(device="cpu").manual_seed(0)
    A = torch.randn(128, 3, 3, generator=g).to(dev)
    S = A @ A.transpose(-1, -2) + 0.01 * torch.eye(3, device=dev)
    t = torch.ones((), device=dev)
    probes = {
        "bool() of a device tensor (control: waits)": lambda: bool(t),
        "a 3x3 matrix product (control: does not wait)": lambda: S[0] @ S[0],
        "eigh_or_nan [3, 3]": lambda: m3.eigh_or_nan(S[0]),
        "eigh_or_nan [128, 3, 3]": lambda: m3.eigh_or_nan(S),
        "svd_or_nan [3, 3]": lambda: m3.svd_or_nan(A[0]),
        "svd_or_nan [128, 3, 3]": lambda: m3.svd_or_nan(A),
    }
    out = {}
    for name, fn in probes.items():
        r = out[name] = blocking_probe(torch, fn)
        print(f"  {name}: {'waits for' if r['blocks'] else 'does not wait for'} the device "
              f"(returned {r['host_ms']:.2f} ms after the call, behind a {r['spin_ms']:.2f} ms "
              f"spin); {r['syncs_seen']} sync(s) seen by the census")
    names = list(probes)
    assert out[names[0]]["blocks"] and out[names[0]]["syncs_seen"] == 1, out[names[0]]
    assert not out[names[1]]["blocks"] and out[names[1]]["syncs_seen"] == 0, out[names[1]]
    return out


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
    one nvcc each started together; then the sweep-log library (phase 7's
    host runtime, ``runtime/sweeplog.cc``) with g++."""
    phase("build")
    from rgc_slam_tpu_torch.runtime import loader

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
    t0 = time.perf_counter()
    slog = loader.build()
    print(f"built {slog} in {time.perf_counter() - t0:.2f} s")
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


def bound_ms(nq: int, n: int, k: int, n_valid: int, lanes: int = 1):
    """(least time in ms, what bounds it) for one call of ``lanes`` searches:
    8 float32 operations for each pair of a query and one of the ``n_valid``
    unmasked points of its lane (summed over the lanes) at PEAK_FLOPS, or
    queries, points, mask and outputs moved once at PEAK_BYTES."""
    t_ops = 8 * nq * n_valid / PEAK_FLOPS
    t_bytes = lanes * (12 * nq + 13 * n + 8 * nq * k) / PEAK_BYTES
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
    return _compare(torch, q, p, k, d_k, i_k, d_p, i_p, exact)


def _compare(torch, q, p, k, d_k, i_k, d_p, i_p, exact: bool):
    """``_check_case``'s test of one search's kernel result against the
    plain one: (max distance error, near-tie index swaps)."""
    assert d_k.shape == d_p.shape == (q.shape[0], k) and i_k.dtype == torch.int32
    assert bool(((i_k >= 0) & (i_k < p.shape[0])).all()), "index out of range"
    c = q.mean(0)
    qc, pc = (q - c).double(), (p - c).double()
    scale = float((qc * qc).sum(-1).max() + (pc * pc).sum(-1).max())
    tol = 1e-5 * scale
    fin = torch.isfinite(d_p)
    assert bool((torch.isfinite(d_k) == fin).all()), "finite pattern differs"
    err = float((d_k - d_p)[fin].abs().max()) if bool(fin.any()) else 0.0
    if exact:       # bit for bit, NaN in the same places
        assert torch.equal(i_k, i_p), "indices differ on an exact case"
        assert torch.equal(torch.isnan(d_k), torch.isnan(d_p)), "NaN pattern differs"
        assert torch.equal(torch.nan_to_num(d_k), torch.nan_to_num(d_p)), \
            "distances differ on an exact case"
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
        # loop closure: the keyframe cloud against the voxelized submap, both
        # centred on the candidate keyframe; the GICP/normals self-search
        "loop ICP 2560x16384 k=1": (cloud(2560, -20, 20), cloud(16384, -30, 30), mask(16384), 1),
        "k=1 1000x4096": (cloud(1000, -10, 10), cloud(4096, -10, 10), mask(4096), 1),
        "k=20 ragged 700x5000": (cloud(700, -10, 10), cloud(5000, -10, 10), mask(5000), 20),
        "few unmasked 300x640 k=20": (cloud(300, -5, 5), cloud(640, -5, 5), mask(640, 0.02), 20),
    }
    cases["sp corner 256x8192 k=5"] = (cloud(256, -15, 15, off), cloud(8192, -20, 20, off),
                                       mask(8192), 5)
    cases["sp surf 1024x32768 k=5"] = (cloud(1024, -15, 15, off), cloud(32768, -20, 20, off),
                                       mask(32768), 5)
    pts = cloud(16384, -30, 30)
    cases["self 16384x16384 k=20"] = (pts, pts, mask(16384), 20)
    src = cloud(2560, -20, 20)
    cases["self 2560x2560 k=20"] = (src, src, mask(2560), 20)
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
    # NaN coordinates on the same exact grid (JAX's semantics, as knn_plain
    # has them): in masked points, in unmasked points, in one query (the
    # centre and every unmasked distance NaN), and fewer finite points than k
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)   # noqa: E731
    m = g.random(3000) < 0.8
    grid_nan = np.where(m[:, None], grid, np.nan)
    unmasked_nan = grid.copy()
    unmasked_nan[np.flatnonzero(m)[::7], 1] = np.nan
    qs_nan = qs.copy()
    qs_nan[5, 2] = np.nan
    few = np.zeros(3000, bool)
    few[[3, 1500, 1501, 2990]] = True
    few_nan = grid.copy()
    few_nan[1500] = np.nan
    mt = lambda a: torch.from_numpy(a).to(dev)                                      # noqa: E731
    exact.update({
        "NaN masked points 256x3000 k=5": (t(qs), t(grid_nan), mt(m), 5),
        "NaN unmasked points 256x3000 k=8": (t(qs), t(unmasked_nan), mt(m), 8),
        # 8 masked points: 8 slots at +inf, then NaN distances, clamped to NaN
        "NaN query 256x3000 k=20": (t(qs_nan), t(grid), mt(np.arange(3000) % 375 != 7), 20),
        "NaN, fewer finite than k 256x3000 k=6": (t(qs), t(few_nan), mt(few), 6),
    })
    # phase 9's GICP-MP fusion search, every target point valid as there;
    # and at the same shape on exact grid coordinates (queries summing to
    # zero), where the kernel and the plain version agree bit for bit
    cases["gicp-mp fuse 2560x16384 k=16"] = (cloud(2560, -5, 10), cloud(16384, -5, 10),
                                             mask(16384, 1.0), 16)
    grid_fuse = g.integers(-8, 9, (16384, 3)).astype(np.float32)
    qs_fuse = g.integers(-8, 9, (2560, 3)).astype(np.float32)
    qs_fuse[-1] = -qs_fuse[:-1].sum(0)
    exact["exact gicp-mp fuse 2560x16384 k=16"] = (t(qs_fuse), t(grid_fuse),
                                                   mt(g.random(16384) < 0.9), 16)
    # phase 10's association at BASE and tools.eval_longrun's searches, drawn
    # after every earlier case (whose inputs stay as they were)
    cases["base corner 512x4096 k=5"] = (cloud(512, -15, 15, off), cloud(4096, -20, 20, off),
                                         mask(4096), 5)
    cases["base surf 2048x16384 k=5"] = (cloud(2048, -15, 15, off), cloud(16384, -20, 20, off),
                                         mask(16384), 5)
    cases["longrun corner 256x1024 k=5"] = (cloud(256, -15, 15, off), cloud(1024, -20, 20, off),
                                            mask(1024), 5)
    cases["longrun surf 1024x4096 k=5"] = (cloud(1024, -15, 15, off), cloud(4096, -20, 20, off),
                                           mask(4096), 5)
    cases["longrun loop ICP 1280x8192 k=1"] = (cloud(1280, -20, 20), cloud(8192, -30, 30),
                                               mask(8192), 1)
    # phase 11's searches, drawn after every earlier case
    cases["entry corner 128x1024 k=5"] = (cloud(128, -15, 15, off), cloud(1024, -20, 20, off),
                                          mask(1024), 5)
    cases["dryrun sp corner 64x1024 k=5"] = (cloud(64, -15, 15, off), cloud(1024, -20, 20, off),
                                             mask(1024), 5)
    cases["dryrun sp surf 256x4096 k=5"] = (cloud(256, -15, 15, off), cloud(4096, -20, 20, off),
                                            mask(4096), 5)
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


# The fleet's searches (phase 3, batched): FLEET_CONFIG's mapping shapes and
# its loop-ICP 1-NN (the keyframe's 256 + 1024 points against the 4096-point
# submap) at B = 1, 3 and FLEET_B lanes, and phase 6b's loop ICP at the
# default config on 3 lanes.  Lane b keeps a different share of its points.
FLEET_SHAPES = {"fleet corner 256x2048 k=5": (256, 2048, 5), "fleet surf 1024x8192 k=5": (1024, 8192, 5),
                "fleet loop ICP 1280x4096 k=1": (1280, 4096, 1)}
LOOP_ICP_3 = ("loop ICP 2560x16384 k=1", 3)
# tools.eval's fleets: config 5's 64 robots at FLEET_CONFIG, config 5b's 4
# robots at eval.py's BASE with the fleet loop step
EVAL_BATCHED = (("fleet corner 256x2048 k=5", (256, 2048, 5), 64),
                ("fleet surf 1024x8192 k=5", (1024, 8192, 5), 64),
                ("base corner 512x4096 k=5", (512, 4096, 5), 4),
                ("base surf 2048x16384 k=5", (2048, 16384, 5), 4),
                ("loop ICP 2560x16384 k=1", (2560, 16384, 1), 4))
# phase 11: the dry run's one-process reference fleet (2 robots at
# ENTRY_CONFIG) and tools.bench's fleet at BENCH_CUT's 8 robots
ENTRY_BATCHED = (("entry corner 128x1024 k=5", (128, 1024, 5), 2),
                 ("entry surf 512x4096 k=5", (512, 4096, 5), 2),
                 ("fleet corner 256x2048 k=5", (256, 2048, 5), BENCH_CUT["FLEET_B"]),
                 ("fleet surf 1024x8192 k=5", (1024, 8192, 5), BENCH_CUT["FLEET_B"]))


def batched_cases(torch, dev):
    """{name: (queries [B,Q,3], points [B,N,3], mask [B,N], k)}."""
    g = np.random.default_rng(1)
    off = (35.0, -12.0, 0.5)
    cases = {}
    shapes = [(name, shape, lanes) for name, shape in FLEET_SHAPES.items() for lanes in (1, 3, FLEET_B)]
    shapes.append((LOOP_ICP_3[0], (2560, 16384, 1), LOOP_ICP_3[1]))
    shapes.extend(EVAL_BATCHED)
    shapes.extend(ENTRY_BATCHED)
    for name, (nq, n, k), lanes in shapes:
        q = g.uniform(-15, 15, (lanes, nq, 3)) + off
        pts = g.uniform(-20, 20, (lanes, n, 3)) + off
        keep = np.linspace(0.5, 0.95, lanes)[:, None] if lanes > 1 else np.full((1, 1), 0.9)
        cases[f"B={lanes} {name}"] = (
            torch.from_numpy(q.astype(np.float32)).to(dev),
            torch.from_numpy(pts.astype(np.float32)).to(dev),
            torch.from_numpy(g.random((lanes, n)) < keep).to(dev), k)
    return cases


def batched_phase(torch, knn_ops, knn_cuda, dev):
    """One launch for B lanes: bit-identical to B launches of one lane each,
    and within ``_check_case``'s tolerance of the batched plain version."""
    phase("batched kernel vs lanes and plain")
    cases = batched_cases(torch, dev)
    max_err = 0.0
    for name, (q, p, m, k) in cases.items():
        d, i = knn_cuda.knn(q, p, m, k)
        d_p, i_p = knn_ops.knn_plain(q, p, m, k)
        torch.cuda.synchronize()
        d1, i1 = knn_cuda.knn(q, p, m, k, chunks=1)
        assert torch.equal(d, d1) and torch.equal(i, i1), f"{name}: one chunk differs"
        err, swapped = 0.0, 0
        for b in range(q.shape[0]):
            db, ib = knn_cuda.knn(q[b], p[b], m[b], k)
            assert torch.equal(d[b], db) and torch.equal(i[b], ib), f"{name}: lane {b} differs"
            e, n_sw = _compare(torch, q[b], p[b], k, d[b], i[b], d_p[b], i_p[b], exact=False)
            err, swapped = max(err, e), swapped + n_sw
        max_err = max(max_err, err)
        print(f"  {name}: bit-identical to one chunk and to {q.shape[0]} one-lane launches; "
              f"max |d_kernel - d_plain| = {err:.3e}, near-tie index swaps = {swapped}")
    return max_err, cases


def split_phase(torch, knn_cuda, cases):
    """One chunk, the planned split and a ragged split: bit-identical."""
    phase("split invariance")
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {}
    for name in MAIN_SHAPES + LOOP_SHAPES + REG_SHAPES + EVAL_SHAPES:
        q, p, m, k_path = cases[name]
        n = p.shape[0]
        ragged = next(s for s in (7, 5, 3) if n % -(-n // s))
        for k in ((5, 20) if name in MAIN_SHAPES else (k_path,)):
            plan = knn_cuda.split_plan(q.shape[0], n, k, num_sms)
            d1, i1 = knn_cuda.knn(q, p, m, k, chunks=1)
            for chunks in (plan.chunks, ragged):
                d, i = knn_cuda.knn(q, p, m, k, chunks=chunks)
                assert torch.equal(d, d1) and torch.equal(i, i1), f"{name} k={k} S={chunks} differs"
            plans[f"{name.rsplit(' ', 1)[0]} k={k}"] = plan._asdict()
            print(f"  {q.shape[0]}x{n} k={k}: chunks 1 = {plan.chunks} (planned: blocks of "
                  f"{plan.threads} queries, {plan.blocks(q.shape[0])} blocks) = {ragged} (ragged): "
                  f"bit-identical")
    return plans


def timing_phase(torch, knn_ops, knn_cuda, cases, smi, prev=None):
    """Kernel and plain version in turns (plain, kernel, kernel, plain), and
    the staged earlier kernel in turns with the kernel where there is one.
    The batched cases (a ``B=`` prefix) are timed as one launch of all
    their lanes, the plain version over the same batch (10 calls a turn at
    64 lanes or more, whose plain distance matrices take gigabytes)."""
    phase("kernel timing")
    timings = {}
    timed = (list(MAIN_SHAPES + SP_SHAPES + LOOP_SHAPES + REG_SHAPES + EVAL_SHAPES + LONGRUN_SHAPES
                  + ENTRY_SHAPES)
             + [n for n in cases if n.startswith(f"B={FLEET_B} ")])
    timed.append(f"B={LOOP_ICP_3[1]} {LOOP_ICP_3[0]}")
    timed += [f"B={lanes} {name}" for name, _, lanes in EVAL_BATCHED + ENTRY_BATCHED]
    for name in timed:
        q, p, m, k = cases[name]
        lanes = q.shape[0] if q.ndim == 3 else 1
        nq, n = q.shape[-2], p.shape[-2]
        reps = 10 if lanes >= 64 else 50
        plain = lambda: knn_ops.knn_plain(q, p, m, k)   # noqa: E731
        kern = lambda: knn_cuda.knn(q, p, m, k)          # noqa: E731
        t_plain = _time_ms(torch, plain, reps)
        t_kern = _time_ms(torch, kern)
        t_kern2 = _time_ms(torch, kern)
        t_plain2 = _time_ms(torch, plain, reps)
        bound, bound_by = bound_ms(nq, n, k, int(m.sum()), lanes)
        plan = knn_cuda.split_plan(nq, n, k, torch.cuda.get_device_properties(q.device)
                                   .multi_processor_count, lanes=lanes)
        row = {"kernel_ms": [t_kern, t_kern2], "plain_ms": [t_plain, t_plain2],
               "bound_ms": bound, "bound_by": bound_by, "key": shape_key(q, p, k),
               "chunks": plan.chunks, "lanes": lanes}
        print(f"  {name}: kernel {t_kern:.4f} / {t_kern2:.4f} ms, plain {t_plain:.4f} / "
              f"{t_plain2:.4f} ms, bound {bound * 1e3:.3f} us ({bound_by}), share of bound "
              f"{bound / t_kern:.2%} (device time per call, mean of 50 queued calls, plain "
              f"{reps}; {smi})")
        if prev is not None and name in MAIN_SHAPES:
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


def _drive(torch, knn_cuda, system, seq, cfg, dev):
    """Feeds every scan of ``seq`` to ``system.process``, synchronized after
    each: (wall ms per scan, kNN launches per scan, kNN launches per scan
    by (queries, points, k), the flags of each loop step's ``LoopInfo`` as
    the system kept it, with its scan)."""
    from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval

    walls, launches, scan_shapes, loops = [], [], [], []
    for k, scan in enumerate(seq["scans"]):
        t_imu, acc, gyr = seq["imu"][k]
        before, shapes_before = knn_cuda.launches, knn_cuda.launches_by_shape.copy()
        t0 = time.perf_counter()
        cloud = cloud_from_scan_dict(scan, cfg, dev)
        imu = imu_from_interval(t_imu, acc, gyr, cfg.max_imu, dev)
        out = system.process(cloud, imu, seq["stamps"][k])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(knn_cuda.launches - before)
        scan_shapes.append(knn_cuda.launches_by_shape - shapes_before)
        assert out.t_map.shape == (3,) and out.q_map.shape == (4,)
        info = system.loop_info
        if info is not None:
            loops.append({"scan": k + 1, "attempted": bool(info.attempted),
                          "accepted": bool(info.accepted), "candidate": int(info.candidate),
                          "fitness": float(info.fitness), "pgo_ran": bool(info.pgo_ran)})
    return walls, launches, scan_shapes, loops


def _check_poses(system):
    """Finite map-frame positions and unit quaternions: the positions."""
    from rgc_slam_tpu_torch.models.slam import trajectory_xyz

    est = trajectory_xyz(system)
    quats = np.stack([q for _, q, _ in system.trajectory])
    assert np.isfinite(est).all() and np.isfinite(quats).all(), "non-finite pose"
    assert np.allclose(np.linalg.norm(quats, axis=1), 1.0, atol=1e-4), "non-unit quaternion"
    return est


def _wall_summary(walls, smi):
    med = statistics.median(walls)
    p90 = float(np.percentile(walls, 90))
    print(f"  wall ms/scan: median {med:.1f}, p90 {p90:.1f} (all {len(walls)} scans); "
          f"median {statistics.median(walls[2:]):.1f} after 2 warm-up scans — {smi}")
    print("  wall ms per scan: " + " ".join(f"{w:.1f}" for w in walls))
    return med, p90


def main_path_phase(torch, knn_cuda, smi, dev):
    phase("main path without loops")
    from rgc_slam_tpu_torch.config import SlamConfig
    from rgc_slam_tpu_torch.io import synthetic
    from rgc_slam_tpu_torch.models.slam import SlamSystem
    from rgc_slam_tpu_torch.utils.evaluation import ate_rmse

    from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu_torch.types import tree_map

    cfg = SlamConfig(loop_closure_enable=False)
    seq = synthetic.generate_sequence(**SEQ_ARGS)
    last = len(seq["scans"]) - 1

    class Keeping(SlamSystem):
        """Keeps a copy of the state before the last scan: the census
        replays that scan."""

        def process(self, cloud, imu, stamp):
            if self._frame == last:
                self.before_last = tree_map(torch.clone, self.state)
            return super().process(cloud, imu, stamp)

    system = Keeping(cfg, device=dev)
    per_scan = 4 * cfg.map_opt_iterations     # edge x2 + plane x2 per outer iteration
    n_pts = int(seq["scans"][0]["xyz"].shape[0])
    print(f"  {len(seq['scans'])} scans of {n_pts} points, max_points={cfg.max_points}")

    knn_cuda.reset_counts()
    walls, launches, _, _ = _drive(torch, knn_cuda, system, seq, cfg, dev)
    total_launches, shape_counts = knn_cuda.launches, by_shape(knn_cuda.launches_by_shape)

    est = _check_poses(system)
    assert all(n == per_scan for n in launches), f"kNN launches per scan {launches}"
    gt = np.stack([t for (_, t) in seq["poses"]])
    ate = ate_rmse(est, gt)
    gate = 1.05 * ATE_JAX + 0.01
    print(f"  ATE {ate:.5f} m (JAX {ATE_JAX:.5f} m, gate {ATE_GATE} = {gate:.5f} m)")
    assert ate <= gate, f"ATE {ate} above {gate}"
    med, p90 = _wall_summary(walls, smi)
    print(f"  kNN kernel launches: {total_launches} ({per_scan} per scan)")
    digest = t_map_digest(est)
    print(f"  t_map digest {digest} (sha256 of the float32 positions)")

    # the census: the last scan once more, from a copy of the state before
    # it, as _drive feeds a scan (the host-to-device copies, process); then
    # the control, one bool() of a device tensor
    replay = SlamSystem(cfg, device=dev)
    replay.state, replay._frame = system.before_last, last
    t_imu, acc, gyr = seq["imu"][last]
    control = torch.ones((), device=dev)
    torch.cuda.synchronize()
    with SyncCensus(torch, f"one steady scan (phase 4: scan {last + 1} replayed, "
                           f"SlamSystem.process with its host-to-device copies)") as census:
        cloud = cloud_from_scan_dict(seq["scans"][last], cfg, dev)
        imu = imu_from_interval(t_imu, acc, gyr, cfg.max_imu, dev)
        replay.process(cloud, imu, seq["stamps"][last])
        census_control(control)
    torch.cuda.synchronize()
    gap = float(np.abs(replay.trajectory[-1][2] - est[-1]).max())
    print(f"  census: scan {last + 1} replayed from a copy of its state, {gap:.3e} m from the "
          f"run's pose (gate {REPLAY_GATE} m)")
    assert gap <= REPLAY_GATE, gap
    syncs = census.report()
    seen = census.sites[CONTROL_SITE]
    print(f"  the census's control ({CONTROL_SITE[0]}:{CONTROL_SITE[1]}, one bool()) counted "
          f"{seen} time(s): {'OK' if seen == 1 else 'FAILED'}")
    assert seen == 1, f"the census's control was counted {seen} times, not once"
    probes = sync_probes(torch, dev)
    return {"ate_m": ate, "ate_jax_m": ATE_JAX, "wall_ms": walls, "median_ms": med,
            "p90_ms": p90, "launches": total_launches, "launches_per_scan": launches,
            "launches_by_shape": shape_counts, "t_map": est.tolist(), "t_map_digest": digest,
            "sync_census": syncs, "sync_probes": probes}


def t_map_digest(t_map) -> str:
    """The first 16 hex digits of the sha256 of the map-frame positions as
    float32 [scans, 3]: two runs that agree bit for bit share it."""
    return hashlib.sha256(np.ascontiguousarray(t_map, np.float32).tobytes()).hexdigest()[:16]


def _clone(torch, pair):
    from rgc_slam_tpu_torch.types import tree_map

    return tuple(tree_map(torch.clone, x) for x in pair)


def _loop_residual(torch, ms, ls, slot: int) -> float:
    """Norm of the 4-DoF residual of the loop in ``slot`` at the keyframe
    poses of ``ms``, yaw in degrees as the PGO weighs it."""
    from rgc_slam_tpu_torch.ops.factors import fourdof_residual
    from rgc_slam_tpu_torch.utils import math3d as m3

    i, j = int(ls.loop_i[slot]), int(ls.loop_j[slot])
    yaw = m3.quat_to_ypr(ms.kf_q[[j, i]])[:, 0]
    r = fourdof_residual(yaw[0], ms.kf_t[j], yaw[1], ms.kf_t[i], ls.loop_t[slot],
                         ls.loop_yaw[slot], ls.loop_pitch_j[slot], ls.loop_roll_j[slot])
    return float(torch.linalg.norm(torch.cat([r[:3], r[3:] * 57.29577951308232])))


def loop_path_phase(torch, knn_cuda, smi, dev):
    """Phase 5.  Returns (its record, the (state, loop state) that the first
    accepting loop step started from, {kind: (inputs, outputs, LoopInfo)} of
    the first loop step of each kind, the config)."""
    phase("main path with loops")
    from rgc_slam_tpu_torch.config import SlamConfig
    from rgc_slam_tpu_torch.io import synthetic
    from rgc_slam_tpu_torch.models import loop as loop_mod
    from rgc_slam_tpu_torch.models.slam import SlamSystem
    from rgc_slam_tpu_torch.utils.evaluation import ate_rmse

    cfg = SlamConfig(**LOOP_CFG)
    assert cfg.loop_closure_enable and cfg.loop_icp_method == "point"
    seq = synthetic.generate_sequence(**LOOP_SEQ_ARGS)

    class Recording(SlamSystem):
        """Times each loop step alone (synchronized on both sides) and
        copies its inputs, and its outputs when it accepts a loop, for the
        checks below; the copies' own time is kept apart.  The first step
        of each kind (no candidate, a rejected candidate, an accepted loop)
        keeps its inputs, outputs and LoopInfo for phase 6b."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.records = []
            self.kinds = {}

        def loop_step(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start = _clone(torch, (self.state, self.loop_state))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            info = super().loop_step()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rec = {"ms": (t2 - t1) * 1e3}
            kind = ("accepted" if bool(info.accepted) else "rejected" if float(info.fitness) > 0
                    else "no candidate")
            if bool(info.accepted) or kind not in self.kinds:
                end = _clone(torch, (self.state, self.loop_state))
                if bool(info.accepted):
                    rec.update(start=start, end=end)
                self.kinds.setdefault(kind, (start, end, info))
            rec["copy_ms"] = (t1 - t0 + time.perf_counter() - t2) * 1e3
            self.records.append(rec)
            return info

    system = Recording(cfg, device=dev)
    per_scan = 4 * cfg.map_opt_iterations
    per_icp = cfg.loop_icp_iterations + 1      # one 1-NN per ICP iteration + the fitness pass
    icp_shape = (1, cfg.max_kf_corner + cfg.max_kf_surf, cfg.max_loop_submap_points, 1)
    n_pts = int(seq["scans"][0]["xyz"].shape[0])
    print(f"  {len(seq['scans'])} scans of {n_pts} points; SlamConfig({LOOP_CFG}): loop_cadence "
          f"{cfg.loop_cadence}, max_keyframes {cfg.max_keyframes}, max_loop_submap_points "
          f"{cfg.max_loop_submap_points}, loop_submap_halfwidth {cfg.loop_submap_halfwidth}")

    knn_cuda.reset_counts()
    walls, launches, scan_shapes, steps = _drive(torch, knn_cuda, system, seq, cfg, dev)
    total_launches, shape_counts = knn_cuda.launches, by_shape(knn_cuda.launches_by_shape)

    # the scans' wall times without the copies; each accepting step's PGO
    # once more on its own inputs (the mapping before the step, the loop
    # store after it), timed alone
    assert len(system.records) == len(steps), "loop steps missing from the record"
    for st, rec in zip(steps, system.records):
        walls[st["scan"] - 1] -= rec["copy_ms"]
        st.update(rec)
        st["launches"] = scan_shapes[st["scan"] - 1][icp_shape]
        if st["accepted"]:
            start, end = st["start"], st["end"]
            assert int(end[0].mapping.kf_count) == int(start[0].mapping.kf_count), "compacted"
            mapping_in = _clone(torch, start)[0].mapping
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop_mod._pgo_solve(mapping_in, end[1], cfg)
            torch.cuda.synchronize()
            st["pgo_ms"] = (time.perf_counter() - t0) * 1e3
        print(f"  loop step at scan {st['scan']}: attempted {st['attempted']}, candidate "
              f"{st['candidate']}, fitness {st['fitness']:.4f}, accepted {st['accepted']}, "
              f"{st['launches']} loop-ICP kNN launches, {st['ms']:.1f} ms"
              + (f" (its PGO alone: {st['pgo_ms']:.1f} ms)" if st["accepted"] else ""))
    est = _check_poses(system)
    n_loops = int(system.loop_state.loop_count)
    accepting = [st for st in steps if st["accepted"]]
    assert n_loops >= 1 and accepting, "no loop accepted"
    assert all(st["pgo_ran"] == st["accepted"] for st in steps), "PGO flag differs from acceptance"
    assert len(steps) == len(seq["scans"]) // cfg.loop_cadence, "loop steps missing"
    assert all(st["launches"] in (0, per_icp) for st in steps), [st["launches"] for st in steps]
    assert all(n in (per_scan, per_scan + per_icp) for n in launches), f"launches per scan {launches}"
    assert per_scan + per_icp in launches, "no loop ICP ran"
    assert sum(launches) == total_launches == sum(shape_counts.values())

    # the first accepted loop against the JAX package's, and its PGO: the
    # loop's residual at the keyframe poses before and after the step
    first = accepting[0]
    (s0, _), (s1, l1) = first["start"], first["end"]
    slot = int(torch.argmax(l1.loop_stamp))
    got = {"scan": first["scan"], "loop_i": int(l1.loop_i[slot]), "loop_j": int(l1.loop_j[slot]),
           "loop_t": l1.loop_t[slot].cpu().tolist(), "loop_yaw": float(l1.loop_yaw[slot])}
    dt = max(abs(a - b) for a, b in zip(got["loop_t"], FIRST_LOOP_JAX["loop_t"]))
    dyaw = abs(got["loop_yaw"] - FIRST_LOOP_JAX["loop_yaw"])
    print(f"  first loop: scan {got['scan']}, keyframes {got['loop_i']} -> {got['loop_j']}, loop_t "
          f"{got['loop_t']}, loop_yaw {got['loop_yaw']:.6f} (JAX: scan {FIRST_LOOP_JAX['scan']}, "
          f"{FIRST_LOOP_JAX['loop_i']} -> {FIRST_LOOP_JAX['loop_j']}; |d loop_t| {dt:.4f} m, gate "
          f"{FIRST_LOOP_GATE['t']} m; |d loop_yaw| {dyaw:.5f} rad, gate {FIRST_LOOP_GATE['yaw']} rad)")
    assert (got["scan"], got["loop_j"]) == (FIRST_LOOP_JAX["scan"], FIRST_LOOP_JAX["loop_j"]), got
    assert dt <= FIRST_LOOP_GATE["t"] and dyaw <= FIRST_LOOP_GATE["yaw"], (dt, dyaw)
    r_before = _loop_residual(torch, s0.mapping, l1, slot)
    r_after = _loop_residual(torch, s1.mapping, l1, slot)
    print(f"  its 4-DoF residual: {r_before:.4f} before the PGO, {r_after:.4f} after "
          f"(gate: at most {PGO_GAIN} x before)")
    assert r_after <= PGO_GAIN * r_before, (r_before, r_after)

    gt = np.stack([t for (_, t) in seq["poses"]])
    ms_ = system.state.mapping
    n_kf = int(ms_.kf_count)
    kf_stamp = ms_.kf_stamp[:n_kf].cpu().numpy()
    kf_t = ms_.kf_t[:n_kf].cpu().numpy()
    assert np.isfinite(kf_t).all()
    result = {"ate_m": ate_rmse(est, gt),
              "kf_ate_m": ate_rmse(kf_t, gt_at_keyframes(kf_stamp, seq["stamps"], gt))}
    for key, name in (("ate", "ate_m"), ("kf_ate", "kf_ate_m")):
        gate = max(1.05 * LOOP_JAX[key] + 0.01, LOOP_JAX_WORST[key] + 0.01)
        print(f"  {key} {result[name]:.5f} m (JAX {LOOP_JAX[key]:.5f} m, worst perturbed "
              f"{LOOP_JAX_WORST[key]:.5f} m; gate {LOOP_GATE} = {gate:.5f} m)")
        assert result[name] <= gate, f"{key} {result[name]} above {gate}"
    print(f"  accepted loops {n_loops} (JAX {LOOP_JAX['loops']}), keyframes {n_kf}")

    med, p90 = _wall_summary(walls, smi)
    print(f"  (a scan with a loop step: its wall less the copies taken for the checks, "
          f"{' '.join('%.1f' % st['copy_ms'] for st in steps)} ms)")
    with_icp = [st["ms"] for st in steps if st["launches"]]
    without = [st["ms"] for st in steps if not st["launches"]]
    pgo_ms = [st["pgo_ms"] for st in accepting]
    print(f"  loop step ms, with ICP: {' '.join(f'{t:.1f}' for t in with_icp)}; without "
          f"ICP: {' '.join(f'{t:.1f}' for t in without)}; PGO ms: "
          f"{' '.join(f'{t:.1f}' for t in pgo_ms)} — {smi}")
    print(f"  kNN kernel launches: {total_launches} ({per_scan} per scan, + {per_icp} per loop "
          f"ICP on {len(with_icp)} loop steps)")
    # the census: the first accepting loop step (loop ICP and PGO) once
    # more, from a copy of its inputs
    torch.cuda.synchronize()
    with SyncCensus(torch, f"one loop step with ICP and its PGO (phase 5: the step at scan "
                           f"{first['scan']} replayed, loop_closure_step)") as census:
        r_state, _, r_info = loop_mod.loop_closure_step(*_clone(torch, first["start"]), cfg)
    torch.cuda.synchronize()
    gap = float((r_state.mapping.kf_t - s1.mapping.kf_t).abs().max())
    print(f"  census: the loop step replayed, accepted {bool(r_info.accepted)}, keyframes "
          f"{gap:.3e} m from the run's (gate {REPLAY_GATE} m)")
    assert bool(r_info.accepted) and gap <= REPLAY_GATE, (bool(r_info.accepted), gap)
    result["sync_census"] = census.report()
    start = first["start"]
    kinds = system.kinds
    for st in accepting:
        del st["start"], st["end"]
    result.update(ate_jax_m=LOOP_JAX["ate"], kf_ate_jax_m=LOOP_JAX["kf_ate"], loops=n_loops,
                  loops_jax=LOOP_JAX["loops"], keyframes=n_kf, wall_ms=walls, median_ms=med,
                  p90_ms=p90, launches=total_launches, launches_per_scan=launches,
                  launches_by_shape=shape_counts, steps=steps, first_loop=got,
                  first_loop_residual=[r_before, r_after], loop_step_icp_ms=with_icp,
                  loop_step_no_icp_ms=without, pgo_ms=pgo_ms)
    return result, start, kinds, cfg


def loop_methods_phase(torch, knn_cuda, smi, start, cfg):
    """Phase 5b: the GICP and point-to-plane loop ICP once each from the
    state the first accepting loop step started from."""
    phase("loop ICP methods")
    from rgc_slam_tpu_torch.models import loop as loop_mod

    # kNN calls: the k=20 self-search of the target (normals, covariances)
    # and, for gicp, of the source; then one 1-NN per LM iteration, one at
    # the final pose and the fitness pass
    src_n, tgt_n = cfg.max_kf_corner + cfg.max_kf_surf, cfg.max_loop_submap_points
    icp_shape = (1, src_n, tgt_n, 1)
    self_shapes = {"gicp": {(1, tgt_n, tgt_n, 20): 1, (1, src_n, src_n, 20): 1},
                   "plane": {(1, tgt_n, tgt_n, 20): 1}}
    result = {}
    for method, expect in self_shapes.items():
        state_in = _clone(torch, start)
        torch.cuda.synchronize()
        knn_cuda.reset_counts()
        t0 = time.perf_counter()
        state, ls, info = loop_mod.loop_closure_step(
            *state_in, dataclasses.replace(cfg, loop_icp_method=method))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = knn_cuda.launches_by_shape.copy()
        m = state.mapping
        for name, x in (("fitness", info.fitness), ("kf_t", m.kf_t), ("kf_q", m.kf_q),
                        ("t_md", m.t_md), ("q_md", m.q_md), ("loop_t", ls.loop_t)):
            assert bool(torch.isfinite(x).all()), f"{method}: non-finite {name}"
        n_nn = counts.pop(icp_shape, 0)
        assert dict(counts) == expect, (method, counts)
        assert 3 <= n_nn <= cfg.loop_icp_iterations + 2, (method, n_nn)
        launches = knn_cuda.launches
        assert launches == n_nn + sum(expect.values())
        print(f"  {method}: fitness {float(info.fitness):.4f}, accepted {bool(info.accepted)}, "
              f"LM iterations {n_nn - 2}, {launches} kNN launches, {ms:.1f} ms — {smi}")
        result[method] = {"fitness": float(info.fitness), "accepted": bool(info.accepted),
                          "iterations": n_nn - 2, "launches": launches, "ms": ms,
                          "launches_by_shape": by_shape(knn_cuda.launches_by_shape)}
    return result


def _fleet_inputs(torch, cfg, seqs, lanes, dev):
    """Per scan, the [B, ...] (clouds, imus, stamps) of the worlds tiled over
    ``lanes`` robots (robot b drives world b % len(seqs)), staged on the
    device before any timing."""
    from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu_torch.types import tree_map, tree_stack

    world = torch.arange(lanes, device=dev) % len(seqs)
    steps = []
    for k in range(len(seqs[0]["scans"])):
        per_world = []
        for seq in seqs:
            t_imu, acc, gyr = seq["imu"][k]
            per_world.append((cloud_from_scan_dict(seq["scans"][k], cfg, dev),
                              imu_from_interval(t_imu, acc, gyr, cfg.max_imu, dev),
                              torch.tensor(seq["stamps"][k], dtype=torch.float32, device=dev)))
        steps.append([tree_map(lambda x: x[world], tree_stack([w[j] for w in per_world]))
                      for j in range(3)])
    return steps


def fleet_phase(torch, knn_cuda, smi, dev):
    """Phase 6: ``fleet_step_compacting`` on FLEET_B robots, no loops."""
    phase("fleet without loops")
    from rgc_slam_tpu_torch.config import FLEET_CONFIG
    from rgc_slam_tpu_torch.io import synthetic
    from rgc_slam_tpu_torch.models.slam import SlamState, slam_step
    from rgc_slam_tpu_torch.parallel import fleet
    from rgc_slam_tpu_torch.types import tree_index, tree_map
    from rgc_slam_tpu_torch.utils.evaluation import ate_rmse

    cfg = dataclasses.replace(FLEET_CONFIG, loop_closure_enable=False)
    seqs = [synthetic.generate_sequence(seed=s, **FLEET_SEQ_ARGS) for s in FLEET_SEEDS]
    steps = _fleet_inputs(torch, cfg, seqs, FLEET_B, dev)
    per_step = 4 * cfg.map_opt_iterations
    print(f"  {FLEET_B} robots over {len(seqs)} worlds ({FLEET_SEQ_ARGS['n_azimuth']} azimuth x 16 "
          f"rings, {len(steps)} scans each); FLEET_CONFIG, loops off")

    states = fleet.fleet_init(cfg, FLEET_B, dev)
    knn_cuda.reset_counts()
    walls, launches, est = [], [], []
    for k, batch in enumerate(steps):
        if k == len(steps) - 1:                  # the census replays the last step
            before_last = tree_map(torch.clone, states)
        before = knn_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, outs = fleet.fleet_step_compacting(states, *batch, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(knn_cuda.launches - before)
        est.append(outs.t_map.cpu().numpy())
    total_launches, shape_counts = knn_cuda.launches, by_shape(knn_cuda.launches_by_shape)
    est = np.stack(est, 1)                               # [B, scans, 3]
    assert np.isfinite(est).all(), "non-finite fleet pose"
    assert all(n == per_step for n in launches), f"kNN launches per fleet step {launches}"

    # lanes of one world: the same result up to the card's scatter-add order
    spread = max(float(np.abs(est[w::len(seqs)] - est[w]).max()) for w in range(len(seqs)))
    print(f"  largest deviation between robots of one world: {spread:.3e} m "
          f"(gate {FLEET_SPREAD_GATE} m)")
    assert spread <= FLEET_SPREAD_GATE, spread

    # robot 0 against a one-robot run of its world over the first scans
    single, one = SlamState.init(cfg, dev), []
    for k in range(FLEET_SINGLE_SCANS):
        clouds, imus, stamps = steps[k]
        single, out = slam_step(single, tree_index(clouds, 0), tree_index(imus, 0), stamps[0], cfg)
        one.append(out.t_map.cpu().numpy())
    dev0 = float(np.abs(np.stack(one) - est[0, :FLEET_SINGLE_SCANS]).max())
    print(f"  robot 0 against one robot alone over {FLEET_SINGLE_SCANS} scans: {dev0:.3e} m "
          f"(gate {FLEET_SINGLE_GATE} m)")
    assert dev0 <= FLEET_SINGLE_GATE, dev0

    ates = []
    for w, seq in enumerate(seqs):
        gt = np.stack([t for (_, t) in seq["poses"]])
        lane_ates = [ate_rmse(est[b], gt) for b in range(w, FLEET_B, len(seqs))]
        gate = max(1.05 * FLEET_JAX[w] + 0.01, FLEET_JAX_WORST[w] + 0.01)
        ates.append(max(lane_ates))
        print(f"  world {FLEET_SEEDS[w]}: ATE {min(lane_ates):.5f}-{max(lane_ates):.5f} m over "
              f"{len(lane_ates)} robots (JAX {FLEET_JAX[w]:.5f} m, worst perturbed "
              f"{FLEET_JAX_WORST[w]:.5f} m; gate {FLEET_GATE} = {gate:.5f} m)")
        assert max(lane_ates) <= gate, (w, lane_ates, gate)

    med, p90 = statistics.median(walls), float(np.percentile(walls, 90))
    rate = FLEET_B * len(walls) / (sum(walls) / 1e3)
    rate_warm = FLEET_B * (len(walls) - 1) / (sum(walls[1:]) / 1e3)
    print(f"  wall ms per fleet step of {FLEET_B} scans: median {med:.1f}, p90 {p90:.1f} (all "
          f"{len(walls)} steps) — {smi}")
    print("  wall ms per fleet step: " + " ".join(f"{w:.1f}" for w in walls))
    print(f"  scans/s: {rate:.1f} over all {len(walls)} steps, {rate_warm:.1f} after the first "
          f"— {smi}")
    print(f"  kNN kernel launches: {total_launches} ({per_step} per fleet step, whatever B) "
          f"{shape_counts}")

    # the census: the last fleet step once more, from a copy of its state,
    # with the poses' read as above
    torch.cuda.synchronize()
    with SyncCensus(torch, f"one fleet step of {FLEET_B} robots (phase 6: step {len(steps)} "
                           f"replayed, fleet_step_compacting)") as census:
        _, outs = fleet.fleet_step_compacting(before_last, *steps[-1], cfg)
        last = outs.t_map.cpu().numpy()
    gap = float(np.abs(last - est[:, -1]).max())
    print(f"  census: fleet step {len(steps)} replayed from a copy of its state, {gap:.3e} m from "
          f"the run's poses (gate {REPLAY_GATE} m)")
    assert gap <= REPLAY_GATE, gap
    syncs = census.report()
    return {"wall_ms": walls, "median_ms": med, "p90_ms": p90, "scans_per_s": rate,
            "scans_per_s_after_first": rate_warm, "launches": total_launches,
            "launches_per_step": launches, "launches_by_shape": shape_counts,
            "world_spread_m": spread, "robot0_vs_single_m": dev0, "ate_m": ates,
            "ate_jax_m": list(FLEET_JAX), "sync_census": syncs}


def fleet_loop_phase(torch, knn_cuda, smi, kinds, cfg):
    """Phase 6b: phase 5's first loop steps of each kind (no candidate,
    rejected, accepted), their inputs stacked into three robots, through
    one ``fleet_loop_step``.  Each robot's LoopInfo flags and candidate must
    equal its single-stream step's, its fitness agree within 1e-3 relative
    or twice the single stream's own spread over two runs on the same
    inputs; the accepted robot's new constraint and keyframe poses must lie
    within FLEET_LOOP_GATE of the single stream's, and its PGO, rerun alone
    on that robot's loop store, within 1e-4 m of the fleet's."""
    phase("fleet loop step on mixed lanes")
    from rgc_slam_tpu_torch.models import loop as loop_mod
    from rgc_slam_tpu_torch.parallel import fleet
    from rgc_slam_tpu_torch.types import tree_index, tree_stack

    order = ("no candidate", "rejected", "accepted")
    missing = [k for k in order if k not in kinds]
    assert not missing, f"phase 5 ran no loop step of kind {missing}"
    states = tree_stack([kinds[k][0][0] for k in order])
    loop_states = tree_stack([kinds[k][0][1] for k in order])
    torch.cuda.synchronize()
    knn_cuda.reset_counts()
    t0 = time.perf_counter()
    states, loop_states, info = fleet.fleet_loop_step(states, loop_states, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    total_launches, shape_counts = knn_cuda.launches, by_shape(knn_cuda.launches_by_shape)
    record = {"ms": ms, "launches": total_launches, "launches_by_shape": shape_counts}
    for b, kind in enumerate(order):
        start, (end_state, end_ls), single = kinds[kind]
        again = loop_mod.loop_closure_step(*_clone(torch, start), cfg)[2]
        for f in ("attempted", "accepted", "candidate", "pgo_ran"):
            assert getattr(info, f)[b].item() == getattr(single, f).item() == getattr(again, f).item(), \
                (kind, f)
        fit, fit_single = float(info.fitness[b]), float(single.fitness)
        tol = max(1e-3 * fit_single, 2 * abs(float(again.fitness) - fit_single))
        assert abs(fit - fit_single) <= tol, (kind, fit, fit_single, tol)
        n = int(end_state.mapping.kf_count)
        assert int(states.mapping.kf_count[b]) == n, kind
        line = (f"  robot {b} ({kind}): flags and candidate ({int(single.candidate)}) as the single "
                f"stream's; fitness {fit:.5f} vs {fit_single:.5f} (tol {tol:.1e})")
        if kind == "accepted":
            slot = int(torch.argmax(end_ls.loop_stamp))

            def devs(ls, ms, lane=()):
                return {"t": float((ls.loop_t[lane + (slot,)] - end_ls.loop_t[slot]).abs().max()),
                        "yaw": abs(float(ls.loop_yaw[lane + (slot,)] - end_ls.loop_yaw[slot])),
                        "kf_t": float((ms.kf_t[lane][:n] - end_state.mapping.kf_t[:n]).abs().max())}

            got = devs(loop_states, states.mapping, (b,))
            gates = FLEET_LOOP_GATE
            assert int(loop_states.loop_j[b, slot]) == int(end_ls.loop_j[slot]), kind
            alone = loop_mod._pgo_solve(start[0].mapping, tree_index(loop_states, b), cfg)
            d_pgo = float((states.mapping.kf_t[b, :n] - alone.kf_t[:n]).abs().max())
            line += (f"; from the single stream's: constraint {got['t']:.2e} m / {got['yaw']:.2e} "
                     f"rad, keyframe poses {got['kf_t']:.2e} m (gates {gates['t']:.0e} m / "
                     f"{gates['yaw']:.0e} rad / {gates['kf_t']:.0e} m); keyframe poses within "
                     f"{d_pgo:.2e} m of its PGO alone")
            print(line)
            assert all(got[key] <= gates[key] for key in got), (got, gates)
            assert d_pgo <= 1e-4, d_pgo
            record.update(lane_dev=got, gates=gates, pgo_dev_m=d_pgo)
        else:
            d_kf = float((states.mapping.kf_t[b, :n] - end_state.mapping.kf_t[:n]).abs().max())
            print(line + f"; keyframe poses {d_kf:.2e} m from the single stream's (must be 0)")
            assert d_kf == 0.0, (kind, d_kf)
    print(f"  one fleet loop step of 3 robots: {ms:.1f} ms, kNN launches {total_launches} "
          f"{shape_counts} — {smi}")
    return record


def fleet_chunk_phase(torch, knn_cuda, smi, dev):
    """Phase 6c: ``make_fleet_chunk_step`` with loops on, FLEET_B robots,
    FLEET_CHUNK scans a call over FLEET_LOOP_SCANS scans: the loop step
    fires at the chunk that holds each cadence boundary."""
    phase("fused fleet with loops")
    from rgc_slam_tpu_torch.config import FLEET_CONFIG
    from rgc_slam_tpu_torch.io import synthetic
    from rgc_slam_tpu_torch.parallel import fleet

    cfg = FLEET_CONFIG
    assert cfg.loop_closure_enable and not fleet._needs_exact_cadence(cfg, FLEET_CHUNK)
    assert FLEET_LOOP_SCANS % FLEET_CHUNK == 0
    seqs = [synthetic.generate_sequence(seed=s, **dict(FLEET_SEQ_ARGS, n_scans=FLEET_LOOP_SCANS + 1))
            for s in FLEET_SEEDS]
    steps = _fleet_inputs(torch, cfg, seqs, FLEET_B, dev)
    step = fleet.make_fleet_chunk_step(cfg, FLEET_CHUNK)
    states, loop_states = fleet.fleet_init(cfg, FLEET_B, dev), fleet.fleet_loop_init(cfg, FLEET_B, dev)
    counter = torch.tensor(0, dtype=torch.int32)
    fired = []
    real_loop_step = fleet.fleet_loop_step

    def counted(*args, **kw):
        fired.append(int(counter) + FLEET_CHUNK)
        return real_loop_step(*args, **kw)

    knn_cuda.reset_counts()
    walls = []
    fleet.fleet_loop_step = counted
    try:
        for k0 in range(0, len(steps), FLEET_CHUNK):
            flat = [x for batch in steps[k0:k0 + FLEET_CHUNK] for x in batch]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states, loop_states, counter, outs = step(states, loop_states, counter, *flat)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            assert all(bool(torch.isfinite(o.t_map).all()) for o in outs), "non-finite fleet pose"
    finally:
        fleet.fleet_loop_step = real_loop_step
    total_launches, shape_counts = knn_cuda.launches, by_shape(knn_cuda.launches_by_shape)
    boundaries = list(range(cfg.loop_cadence, len(steps) + 1, cfg.loop_cadence))
    expect = sorted({-(-b // FLEET_CHUNK) * FLEET_CHUNK for b in boundaries})
    assert int(counter) == len(steps) and fired == expect, (int(counter), fired, expect)
    assert any(b % FLEET_CHUNK for b in boundaries), "no cadence boundary inside a chunk"
    assert bool((loop_states.last_kf_count == states.mapping.kf_count).all())
    print(f"  {FLEET_B} robots, {len(steps)} scans in chunks of {FLEET_CHUNK}: loop steps at the "
          f"chunks ending at scans {fired} (cadence boundaries {boundaries})")
    print(f"  wall ms per chunk of {FLEET_CHUNK} fleet steps: " + " ".join(f"{w:.1f}" for w in walls)
          + f" (the loop step in the chunks ending at {fired}) — {smi}")
    print(f"  kNN kernel launches: {total_launches} {shape_counts}")
    return {"chunk": FLEET_CHUNK, "wall_ms": walls, "fired_at": fired, "launches": total_launches,
            "launches_by_shape": shape_counts,
            "loops": loop_states.loop_count.cpu().tolist()}


def _shard_scans(seq, n: int, cfg, seed=None):
    """The first ``n`` scans of ``seq`` as numpy (cloud fields, imu fields,
    stamp), the scans' coordinates scaled by 1 + 1e-7 x N(0, 1) when
    ``seed`` is given (numpy generator seed * 1000 + scan)."""
    from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
    from rgc_slam_tpu_torch.types import tree_items

    out = []
    for k in range(n):
        scan = dict(seq["scans"][k])
        if seed is not None:
            g = np.random.default_rng(seed * 1000 + k)
            scan["xyz"] = (scan["xyz"] * (1 + 1e-7 * g.standard_normal(scan["xyz"].shape))
                           ).astype(np.float32)
        t_imu, acc, gyr = seq["imu"][k]
        out.append(({n_: v.numpy() for n_, v in tree_items(cloud_from_scan_dict(scan, cfg, "cpu"))},
                    {n_: v.numpy() for n_, v in
                     tree_items(imu_from_interval(t_imu, acc, gyr, cfg.max_imu, "cpu"))},
                    float(seq["stamps"][k])))
    return out


def shard_phase(torch, knn_cuda, smi, dev, main_run):
    """Phase 8: the sharded step on SHARD_RANKS gloo ranks sharing the card."""
    phase("sharded step on the card")
    from rgc_slam_tpu_torch.config import SlamConfig
    from rgc_slam_tpu_torch.io import synthetic
    from rgc_slam_tpu_torch.models.slam import SlamState, slam_step
    from rgc_slam_tpu_torch.parallel.distributed import run_ranks
    from rgc_slam_tpu_torch.tools.smoke_ranks import shard_rank
    from rgc_slam_tpu_torch.types import ImuBatch, PointCloud

    cfg = SlamConfig(loop_closure_enable=False, sp_features=True)
    seq = synthetic.generate_sequence(**SEQ_ARGS)
    scans = _shard_scans(seq, SHARD_SCANS, cfg)
    single = np.asarray(main_run["t_map"][:SHARD_SCANS])

    # the single stream's own deviation: phase 4's config over the same
    # scans perturbed by 1e-7 relative, against phase 4's poses
    base = SlamConfig(loop_closure_enable=False)
    own = 0.0
    for seed in SHARD_PERTURB:
        state, est = SlamState.init(base, dev), []
        for cloud, imu, stamp in _shard_scans(seq, SHARD_SCANS, base, seed):
            state, out = slam_step(
                state, PointCloud(**{k: torch.from_numpy(v).to(dev) for k, v in cloud.items()}),
                ImuBatch(**{k: torch.from_numpy(v).to(dev) for k, v in imu.items()}),
                torch.tensor(stamp, dtype=torch.float32, device=dev), base)
            est.append(out.t_map.cpu().numpy())
        own = max(own, float(np.abs(np.stack(est) - single).max()))
    gate = max(SHARD_GATE, 2 * own)

    t0 = time.perf_counter()
    ranks = run_ranks(shard_rank, SHARD_RANKS, dev, (scans,), timeout_s=SHARD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for r in ranks[1:]:
        assert np.array_equal(r["t_map"], ranks[0]["t_map"]), "ranks' poses differ"
    est = ranks[0]["t_map"]
    assert np.isfinite(est).all(), "non-finite sharded pose"
    dev_single = float(np.abs(est - single).max())
    print(f"  {SHARD_RANKS} ranks (dp=1, sp={SHARD_RANKS}, gloo) on {dev}, one robot, "
          f"SlamConfig(loop_closure_enable=False, sp_features=True), {SHARD_SCANS} scans of phase "
          f"4's sequence: the ranks' poses are bit-equal")
    print(f"  against phase 4's single stream: {dev_single:.3e} m (gate max({SHARD_GATE}, 2 x "
          f"{own:.3e} m, its own deviation under 1e-7 perturbations) = {gate:.3e} m)")
    assert dev_single <= gate, (dev_single, gate)
    sp_keys = {"256x8192 k=5", "1024x32768 k=5"}
    for i, r in enumerate(ranks):
        assert r["launches_per_scan"] == [8] * SHARD_SCANS, (i, r["launches_per_scan"])
        assert all(set(s) == sp_keys and sum(s.values()) == 8 for s in r["shapes_per_scan"]), \
            (i, r["shapes_per_scan"])
        print(f"  rank {i}: kNN launches per scan {r['launches_per_scan']} {r['launches_by_shape']}; "
              f"wall ms per scan (two ranks sharing one card, not a scaling number): "
              + " ".join(f"{w:.1f}" for w in r["wall_ms"]) + f" — {smi}")
    path = Counter()
    for r in ranks:
        path.update(r["launches_by_shape"])
    print(f"  {wall:.1f} s for the ranks' start, their mesh and {SHARD_SCANS} steps")
    return {"pose_dev_m": dev_single, "gate_m": gate, "own_dev_m": own, "wall_s": wall,
            "ranks": [{k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in r.items()}
                      for r in ranks],
            "launches": sum(r["launches"] for r in ranks), "launches_by_shape": dict(path)}


def rbf_phase(torch, knn_cuda, smi, dev):
    """Phase 8b: ``cov_estimation="rbf"`` over phase 8's scans, one process."""
    phase("rbf covariances on the card")
    from rgc_slam_tpu_torch.config import SlamConfig
    from rgc_slam_tpu_torch.io import synthetic
    from rgc_slam_tpu_torch.models.slam import SlamSystem
    from rgc_slam_tpu_torch.utils.evaluation import ate_rmse

    cfg = SlamConfig(loop_closure_enable=False, cov_estimation="rbf")
    full = synthetic.generate_sequence(**SEQ_ARGS)
    seq = {key: full[key][:SHARD_SCANS] for key in ("scans", "imu", "stamps", "poses")}
    system = SlamSystem(cfg, device=dev)
    knn_cuda.reset_counts()
    walls, launches, _, _ = _drive(torch, knn_cuda, system, seq, cfg, dev)
    total, shape_counts = knn_cuda.launches, by_shape(knn_cuda.launches_by_shape)
    est = _check_poses(system)
    assert launches == [8] * SHARD_SCANS, launches
    ate = ate_rmse(est, np.stack([t for (_, t) in seq["poses"]]))
    gate = 1.05 * ATE_JAX_RBF + 0.01
    print(f"  SlamConfig(loop_closure_enable=False, cov_estimation='rbf'), {SHARD_SCANS} scans: ATE "
          f"{ate:.5f} m (JAX {ATE_JAX_RBF:.5f} m, gate {RBF_GATE} = {gate:.5f} m)")
    assert ate <= gate, (ate, gate)
    print("  wall ms per scan: " + " ".join(f"{w:.1f}" for w in walls) + f" — {smi}")
    return {"ate_m": ate, "ate_jax_m": ATE_JAX_RBF, "wall_ms": walls, "launches": total,
            "launches_by_shape": shape_counts}


def registration_scene(n_src: int = REG_SRC, n_tgt: int = REG_TGT, seed: int = REG_SEED):
    """(source [n_src, 3], target [n_tgt, 3], q_gt wxyz, t_gt), float32:
    tests/test_gicp_variants.py's scene (two 10 x 3 m walls and a 10 x 10 m
    ground, 1 cm noise), the source and the target drawn apart from it, the
    target moved by the ZYX rotation REG_YPR and REG_T (float64, rounded
    once)."""
    g = np.random.default_rng(seed)

    def cloud(n):
        a = np.stack([g.uniform(0, 10, n // 3), np.zeros(n // 3), g.uniform(0, 3, n // 3)], 1)
        b = np.stack([np.zeros(n // 3), g.uniform(0, 10, n // 3), g.uniform(0, 3, n // 3)], 1)
        m = n - 2 * (n // 3)
        ground = np.stack([g.uniform(0, 10, m), g.uniform(0, 10, m), np.zeros(m)], 1)
        return np.concatenate([a, b, ground]) + g.normal(0, 0.01, (n, 3))

    y, p, r = (0.5 * a for a in REG_YPR)
    cy, sy, cp, sp, cr, sr = np.cos(y), np.sin(y), np.cos(p), np.sin(p), np.cos(r), np.sin(r)
    q = np.array([cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
                  cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr])
    w, x, yy, z = q
    R = np.array([[1 - 2 * (yy * yy + z * z), 2 * (x * yy - w * z), 2 * (x * z + w * yy)],
                  [2 * (x * yy + w * z), 1 - 2 * (x * x + z * z), 2 * (yy * z - w * x)],
                  [2 * (x * z - w * yy), 2 * (yy * z + w * x), 1 - 2 * (x * x + yy * yy)]])
    src = cloud(n_src).astype(np.float32)
    tgt = (cloud(n_tgt) @ R.T + np.asarray(REG_T)).astype(np.float32)
    return src, tgt, q.astype(np.float32), np.asarray(REG_T, np.float32)


def quat_gap(a, b) -> float:
    """Largest component difference of two unit quaternions, up to sign."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(min(np.abs(a - b).max(), np.abs(a + b).max()))


def registration_phase(torch, knn_cuda, smi, dev):
    """Phase 9: GICP-MP and NDT d2d / p2d on ``registration_scene``."""
    phase("registration library")
    from rgc_slam_tpu_torch.config import SlamConfig
    from rgc_slam_tpu_torch.ops import gicp

    cfg = SlamConfig()
    src, tgt, q_gt, t_gt = registration_scene()
    ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)          # noqa: E731
    args = (torch.from_numpy(src).to(dev), ones(len(src)), torch.from_numpy(tgt).to(dev),
            ones(len(tgt)), torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
            torch.zeros(3, device=dev), cfg)
    print(f"  {len(src)} source and {len(tgt)} target points (tests/test_gicp_variants.py's "
          f"scene), default SlamConfig()")
    out, path = {}, Counter()
    for method, (fn_name, kw) in REG_METHODS.items():
        fn = getattr(gicp, fn_name)
        torch.cuda.synchronize()
        knn_cuda.reset_counts()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        counts = Counter(knn_cuda.launches_by_shape)
        launches = knn_cuda.launches
        t0 = time.perf_counter()
        again = fn(*args, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for name, a, b in zip(res._fields, res, again):
            assert torch.equal(a, b), f"{method}: a second call differs in {name}: {a} vs {b}"
        q, t = res.q.cpu().numpy(), res.t.cpu().numpy()
        it, n_corr = int(res.iterations), int(res.n_corr)
        ref = REG_JAX[method]
        gate = max(REG_FLOOR, 2 * ref["dev"])
        dq, dt = quat_gap(q, ref["q"]), float(np.abs(t - np.asarray(ref["t"])).max())
        truth_t = float(np.abs(t - t_gt).max())
        dot = abs(float(np.dot(q.astype(np.float64), q_gt)))
        print(f"  {method}: iterations {it} (JAX {ref['iterations']}), correspondences {n_corr} "
              f"(JAX {ref['n_corr']}), fitness {float(res.fitness):.6g}; against JAX: q {dq:.3e}, "
              f"t {dt:.3e} m (gate {gate:.3e}); against truth: t {truth_t:.4f} m (limit "
              f"{REG_TRUTH_T[method]}), |<q, q_gt>| {dot:.7f}; {ms:.1f} ms a call — {smi}")
        assert it == ref["iterations"] and n_corr == ref["n_corr"], (method, it, n_corr)
        assert dq <= gate and dt <= gate, (method, dq, dt, gate)
        assert truth_t < REG_TRUTH_T[method] and dot > 0.9999, (method, truth_t, dot)
        assert bool(torch.isfinite(res.H).all()) and np.isfinite(float(res.fitness))
        if fn_name == "gicp_mp_register":
            expect = {(1, len(src), len(src), 20): 1, (1, len(tgt), len(tgt), 20): 1,
                      (1, len(src), len(tgt), 16): it + 1, (1, len(src), len(tgt), 1): 1}
        else:
            expect = {}
        assert dict(counts) == expect, (method, counts, expect)
        assert launches == sum(expect.values())
        path.update(counts)
        out[method] = {"q": q.tolist(), "t": t.tolist(), "iterations": it, "n_corr": n_corr,
                       "fitness": float(res.fitness), "dq": dq, "dt_m": dt, "gate": gate,
                       "truth_t_m": truth_t, "ms": ms, "launches": launches,
                       "launches_by_shape": by_shape(counts)}
    return {"methods": out, "launches": sum(path.values()), "launches_by_shape": by_shape(path)}


def oracle_phase(torch, smi, dev):
    """Phase 9b: the port's stages against the numpy oracles on the card."""
    phase("the port against the numpy oracles")
    from rgc_slam_tpu_torch.utils import parity_gates

    out = {}
    t_all = time.perf_counter()
    for name in ORACLE_GATES:
        t0 = time.perf_counter()
        record = parity_gates.GATES[name](dev)
        torch.cuda.synchronize()
        record["s"] = time.perf_counter() - t0
        measured = {k: v["value"] for k, v in record.items() if isinstance(v, dict) and "value" in v}
        print(f"  {name}: passed in {record['s']:.2f} s; " +
              ", ".join(f"{k} {v:.3e}" for k, v in measured.items()) +
              (f"; the {record['oracle_dtype']} oracle's trace" if "oracle_dtype" in record else ""))
        out[name] = record
    print(f"  {len(ORACLE_GATES)} gates in {time.perf_counter() - t_all:.1f} s — {smi}")
    return out


def eval_phase(torch, knn_cuda, smi, dev):
    """Phase 10: the evaluation programs of ``rgc_slam_tpu_torch.tools`` on
    the card: ``eval.run_sequence`` over the first EVAL_SCANS scans of
    configs 4 and 3, ``eval_stages.stage_rows`` over EVAL_STAGE_REPS calls a
    stage, ``eval_pgo.run_case`` at K=EVAL_PGO_K."""
    phase("evaluation programs on the card")
    from rgc_slam_tpu_torch.tools import eval as teval
    from rgc_slam_tpu_torch.tools import eval_pgo, eval_stages

    knn_cuda.reset_counts()
    t_all = time.perf_counter()
    runs = {}
    for gate, n in EVAL_SCANS.items():
        seq = teval.sequence(gate, True)
        seq = {key: seq[key][:n] for key in ("scans", "imu", "stamps", "poses")}
        r = teval.run_sequence(teval.gate_config(gate), seq, device=dev)
        gate_m = max(1.05 * EVAL_JAX[gate] + 0.01, EVAL_JAX_WORST[gate] + 0.01)
        print(f"  config {gate} ({teval.GATES[gate][0]}), {n} scans: ATE map {r['ate_map_m']} m, "
              f"odom {r['ate_odom_m']} m (JAX {EVAL_JAX[gate]} m, worst perturbed "
              f"{EVAL_JAX_WORST[gate]} m, gate {EVAL_GATE} = {gate_m:.4f} m); "
              f"{r['ms_per_scan']} ms/scan — {smi}")
        assert r["n_scans"] == n and r["ate_map_m"] <= gate_m, (gate, r, gate_m)
        runs[gate] = r

    rows = eval_stages.stage_rows(dev, reps=EVAL_STAGE_REPS, prof_reps=1)
    for r in rows:
        vals = [r["wall_ms"], r["device_ms"], r["kernels"]]
        assert all(v is not None and np.isfinite(v) for v in vals), r
        print(f"  stage {r['stage']}: wall {r['wall_ms']:.2f} ms, device {r['device_ms']:.2f} ms, "
              f"{r['kernels']:.0f} kernels" + (f", busy {r['busy']:.1%}" if r["busy"] else ""))
    by_stage = {r["stage"]: r for r in rows}
    full = by_stage["full_step"]["kernels"]
    assert by_stage["features"]["kernels"] <= full and by_stage["odometry"]["kernels"] <= full, rows

    pgo = eval_pgo.run_case(EVAL_PGO_K, EVAL_PGO_CG, reps=1, device=dev)
    pgo_gate = max(PGO_FLOOR, 2 * PGO_JAX["dev"])
    pgo_dev = abs(pgo["ate_after_m_unrounded"] - PGO_JAX["ate_after"])
    print(f"  PGO K={EVAL_PGO_K}, cg {EVAL_PGO_CG}: ATE {pgo['ate_before_m_unrounded']:.4f} -> "
          f"{pgo['ate_after_m_unrounded']:.6f} m (JAX {PGO_JAX['ate_after']:.6f} m, |diff| "
          f"{pgo_dev:.2e} m, gate max({PGO_FLOOR}, 2 x {PGO_JAX['dev']:.2e}) = {pgo_gate:.2e} m); "
          f"{pgo['latency_ms']} ms — {smi}")
    assert pgo["ate_after_m_unrounded"] < pgo["ate_before_m_unrounded"], pgo
    assert pgo_dev <= pgo_gate, (pgo, PGO_JAX)
    total, shape_counts = knn_cuda.launches, by_shape(knn_cuda.launches_by_shape)
    print(f"  kNN kernel launches: {total} {shape_counts}; {time.perf_counter() - t_all:.1f} s")
    return {"runs": runs, "stages": rows, "pgo": pgo, "launches": total,
            "launches_by_shape": shape_counts}


def entry_bench_phase(torch, knn_cuda, smi, dev):
    """Phase 11: ``tools.graft_entry.entry()`` once, ``dryrun_multichip``
    on ENTRY_RANKS gloo ranks sharing the card (dp=2 x sp=2) with its 5e-3 m
    gate, and ``tools.bench.main`` at BENCH_CUT: one parseable line, every
    rate finite and positive, platform "gpu"."""
    phase("root programs: graft entry and bench")
    from rgc_slam_tpu_torch.tools import bench, graft_entry

    t_all = time.perf_counter()
    knn_cuda.reset_counts()
    t0 = time.perf_counter()
    fn, args = graft_entry.entry(dev)
    _, out = fn(*args)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    entry_counts = Counter(knn_cuda.launches_by_shape)
    assert bool(torch.isfinite(out.t_map).all()) and bool(torch.isfinite(out.q_map).all())
    assert sum(entry_counts.values()) == 4 * graft_entry.ENTRY_CONFIG.map_opt_iterations, entry_counts
    print(f"  entry(): one slam_step at ENTRY_CONFIG in {entry_s:.2f} s, kNN launches "
          f"{by_shape(entry_counts)} — entry OK")

    knn_cuda.reset_counts()
    dry = graft_entry.dryrun_multichip(ENTRY_RANKS, ENTRY_STEPS, device=dev)
    assert (dry["n_dp"], dry["n_sp"]) == (2, 2), dry
    per_step = 4 * graft_entry.ENTRY_CONFIG.map_opt_iterations
    dry_counts = Counter(dry["ref_launches_by_shape"])
    for i, r in enumerate(dry["ranks"]):
        assert r["launches"] == per_step * dry["steps"], (i, r["launches"])
        dry_counts.update(r["launches_by_shape"])
    walls = [statistics.median(r["wall_ms"]) for r in dry["ranks"]]
    print(f"  dryrun_multichip({ENTRY_RANKS}): dp={dry['n_dp']} x sp={dry['n_sp']} gloo ranks on "
          f"{[r['device'] for r in dry['ranks']]}, {dry['steps']} steps: sharded vs one process "
          f"{dry['dev_m']:.3e} m (gate {dry['gate_m']} m), mean fitness {dry['mean_fit']:.5f}; "
          f"{dry['ranks_s']:.1f} s for the ranks, median ms a step per rank "
          + " ".join(f"{w:.1f}" for w in walls) + f" (ranks share one card) — dryrun_multichip OK")
    print(f"  kNN launches: {dict(dry_counts)} (ranks {per_step} a step each, and the reference)")

    saved = {name: getattr(bench, name) for name in BENCH_CUT}
    for name, value in BENCH_CUT.items():
        setattr(bench, name, value)
    knn_cuda.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--device", str(dev)])
    finally:
        for name, value in saved.items():
            setattr(bench, name, value)
    bench_s = time.perf_counter() - t0
    bench_counts = Counter(knn_cuda.launches_by_shape)
    lines = buf.getvalue().strip().splitlines()
    assert rc == 0 and len(lines) == 1, lines
    line = json.loads(lines[0])
    rates = {k: line[k] for k in ("value", "per_dispatch_scans_per_sec", "with_loops_scans_per_sec")}
    assert all(isinstance(v, (int, float)) and np.isfinite(v) and v > 0 for v in rates.values()), line
    assert line["platform"] == "gpu" and line["device"] == torch.cuda.get_device_name(0), line
    assert line["dispatch_mode"] == "pipelined" and line["power_limit"], line
    b, t, r = (BENCH_CUT[k] for k in ("FLEET_B", "N_TIMED", "N_REPS"))
    steps = bench.N_WARMUP + r * t + 2 * (1 + r) * t           # warm-up, per dispatch, chunked, loops
    fc = bench.FLEET_CONFIG
    per_key = 4 * fc.map_opt_iterations // 2                      # corner and surf alike
    fleet_keys = {(b, fc.max_kf_corner, fc.max_map_points // 4, 5),   # 256x2048, 1024x8192
                  (b, fc.max_kf_surf, fc.max_map_points, 5)}
    assert {key: n for key, n in bench_counts.items() if key in fleet_keys} == \
        {key: per_key * steps for key in fleet_keys}, bench_counts
    print(f"  tools.bench at {BENCH_CUT}: {lines[0]}")
    print(f"  {bench_s:.1f} s; kNN launches {by_shape(bench_counts)} ({steps} fleet steps) — {smi}")
    path = Counter(by_shape(entry_counts)) + dry_counts + Counter(by_shape(bench_counts))
    total = sum(path.values())
    print(f"  phase 11 in {time.perf_counter() - t_all:.1f} s")
    return {"entry_s": entry_s, "dryrun": {k: v for k, v in dry.items()
                                           if k not in ("ranks", "traj_sh", "traj_ref")},
            "dryrun_rank_wall_ms": [r["wall_ms"] for r in dry["ranks"]], "bench_line": line,
            "bench_s": bench_s, "launches": total, "launches_by_shape": dict(path)}


def cli_sequence(synthetic, n: int):
    """The first ``n`` scans of phase 4's sequence as ``write_sequence``
    takes them, and their ground-truth positions [n, 3]."""
    seq = synthetic.generate_sequence(**SEQ_ARGS)
    part = {key: seq[key][:n] for key in ("scans", "imu", "stamps")}
    return part, np.stack([t for (_, t) in seq["poses"][:n]])


def write_bag(path: str, seq: dict, compression: str = "lz4"):
    """A rosbag of ``seq`` written with the port's ``BagWriter``: each sweep
    a PointCloud2 with ring and time channels, its IMU window Imu messages."""
    from rgc_slam_tpu_torch.io import rosbag

    with rosbag.BagWriter(path, chunk_size=50, compression=compression) as w:
        for k, scan in enumerate(seq["scans"]):
            t_imu, acc, gyr = seq["imu"][k]
            for j in range(len(t_imu)):
                w.write(rosbag.IMU_TOPIC, "sensor_msgs/Imu", float(t_imu[j]),
                        rosbag.encode_imu(float(t_imu[j]), acc[j], gyr[j]))
            m, stamp = scan["mask"], float(seq["stamps"][k])
            w.write(rosbag.CLOUD_TOPIC, "sensor_msgs/PointCloud2", stamp,
                    rosbag.encode_pointcloud2(stamp, scan["xyz"][m], scan["intensity"][m],
                                              scan["ring"][m].astype(np.uint16),
                                              scan["rel_time"][m]))


def _cli_run(knn_cuda, argv, n_scans: int):
    """``rgc_slam_tpu_torch.run.main(argv)`` with the kNN launches counted
    per ``SlamSystem.process`` call: (wall s, launches per scan, the rows of
    its pose_evo.txt, its timing.json)."""
    from rgc_slam_tpu_torch import run
    from rgc_slam_tpu_torch.models.slam import SlamSystem

    per_scan = []
    process = SlamSystem.process

    def counted(self, *args, **kw):
        before = knn_cuda.launches
        out = process(self, *args, **kw)
        per_scan.append(knn_cuda.launches - before)
        return out

    out_dir = argv[argv.index("--out-dir") + 1]
    SlamSystem.process = counted
    try:
        t0 = time.perf_counter()
        run.main(argv)
        wall = time.perf_counter() - t0
    finally:
        SlamSystem.process = process
    poses = np.loadtxt(os.path.join(out_dir, "pose_evo.txt"), ndmin=2)
    assert poses.shape == (n_scans, 8) and np.isfinite(poses).all(), poses.shape
    assert np.allclose(np.linalg.norm(poses[:, 4:], axis=1), 1.0, atol=1e-4), "non-unit quaternion"
    with open(os.path.join(out_dir, "timing.json")) as f:
        timing = json.load(f)
    assert timing["scan"]["count"] == n_scans, timing
    assert per_scan == [8] * n_scans, f"kNN launches per scan {per_scan}"
    return wall, per_scan, poses, timing


def cli_phase(torch, knn_cuda, smi):
    """Phase 7: ``python -m rgc_slam_tpu_torch.run`` in this process over a
    sweep log of phase 4's scans, then ``--localize`` and ``--bag``."""
    phase("CLI on the card")
    from rgc_slam_tpu_torch.io import synthetic
    from rgc_slam_tpu_torch.io.export import read_pcd
    from rgc_slam_tpu_torch.runtime.loader import write_sequence
    from rgc_slam_tpu_torch.utils.evaluation import ate_rmse

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    seq, gt = cli_sequence(synthetic, CLI_SCANS)
    side = {key: seq[key][:CLI_SIDE_SCANS] for key in seq}
    log, side_log, bag = (os.path.join(CLI_DIR, f) for f in ("seq.slog", "side.slog", "side.bag"))
    write_sequence(log, seq)
    write_sequence(side_log, side)
    write_bag(bag, side)
    ck, out = os.path.join(CLI_DIR, "ckpt"), os.path.join(CLI_DIR, "map")
    print(f"  {CLI_SCANS} scans of {int(seq['scans'][0]['mask'].sum())} valid points in a sweep log "
          f"({os.path.getsize(log) / 1e6:.1f} MB); localize and bag over {CLI_SIDE_SCANS}")

    knn_cuda.reset_counts()
    wall, per_scan, poses, timing = _cli_run(
        knn_cuda, ["--log", log, "--no-loop", "--dump-frames", "--save-ckpt", ck, "--out-dir", out],
        CLI_SCANS)
    frames = sorted(os.listdir(os.path.join(out, "frames")))
    assert frames == [f"frame_{i:06d}.pcd" for i in range(CLI_SCANS)], frames
    for name in frames:
        xyz, _ = read_pcd(os.path.join(out, "frames", name))
        assert len(xyz) > 1000 and np.isfinite(xyz).all(), name
    ate = ate_rmse(poses[:, 1:4], gt)
    gate = 1.05 * ATE_JAX_CLI + 0.01
    print(f"  --log: ATE {ate:.5f} m (JAX CLI {ATE_JAX_CLI:.5f} m, gate {CLI_GATE} = {gate:.5f} m); "
          f"{sum(per_scan)} kNN launches (8 a scan); {CLI_SCANS} frame PCDs; {wall:.1f} s in main")
    assert ate <= gate, f"ATE {ate} above {gate}"
    scan_ms = timing["scan"]
    print(f"  timing.json ms/scan: median {scan_ms['p50_ms']:.1f}, p95 {scan_ms['p95_ms']:.1f}, "
          f"mean {scan_ms['mean_ms']:.1f}, max {scan_ms['max_ms']:.1f} — {smi}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert len(f.readlines()) == CLI_SCANS

    loc = os.path.join(CLI_DIR, "localize")
    loc_wall, loc_scans, loc_poses, _ = _cli_run(
        knn_cuda, ["--log", side_log, "--no-loop", "--localize", ck, "--out-dir", loc],
        CLI_SIDE_SCANS)
    map_pts, map_conf = read_pcd(os.path.join(out, "global_map.pcd"))
    loc_pts, loc_conf = read_pcd(os.path.join(loc, "global_map.pcd"))
    assert np.array_equal(map_pts, loc_pts) and np.array_equal(map_conf, loc_conf), "map moved"
    d_loc = float(np.abs(loc_poses[:, 1:4] - poses[:CLI_SIDE_SCANS, 1:4]).max())
    print(f"  --localize: the frozen map's {len(loc_pts)} points equal the mapping run's; poses "
          f"{d_loc:.3e} m from the mapping run's first {CLI_SIDE_SCANS}; {loc_wall:.1f} s in main")

    bag_out = os.path.join(CLI_DIR, "bag")
    bag_wall, bag_scans, bag_poses, _ = _cli_run(
        knn_cuda, ["--bag", bag, "--no-loop", "--out-dir", bag_out], CLI_SIDE_SCANS)
    d_bag = float(np.abs(bag_poses[:, 1:4] - poses[:CLI_SIDE_SCANS, 1:4]).max())
    print(f"  --bag (lz4 chunks): finite unit poses, {d_bag:.3e} m from the sweep-log run's; "
          f"{bag_wall:.1f} s in main")
    total, shape_counts = knn_cuda.launches, by_shape(knn_cuda.launches_by_shape)
    assert total == sum(per_scan + loc_scans + bag_scans) == sum(shape_counts.values())
    print(f"  kNN kernel launches: {total} {shape_counts}")
    return {"ate_m": ate, "ate_jax_cli_m": ATE_JAX_CLI, "timing": timing, "wall_s": wall,
            "localize_wall_s": loc_wall, "bag_wall_s": bag_wall, "localize_pose_dev_m": d_loc,
            "bag_pose_dev_m": d_bag, "map_points": len(map_pts), "launches": total,
            "launches_per_scan": per_scan + loc_scans + bag_scans,
            "launches_by_shape": shape_counts}


def main() -> int:
    import torch

    smi = device_phase(torch)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import rgc_slam_tpu_torch  # noqa: F401  (precision pins)
    from rgc_slam_tpu_torch.ops import knn as knn_ops
    from rgc_slam_tpu_torch.ops.cuda import knn as knn_cuda

    build_s, regs, prev_lib = build_phase(knn_cuda)
    dev = torch.device("cuda:0")
    max_err, cases = kernel_phase(torch, knn_ops, knn_cuda, dev)
    plans = split_phase(torch, knn_cuda, cases)
    batched_err, batched = batched_phase(torch, knn_ops, knn_cuda, dev)
    cases.update(batched)
    prev = _prev_kernel(torch, prev_lib) if prev_lib else None
    timings = timing_phase(torch, knn_ops, knn_cuda, cases, smi, prev)
    del cases, batched
    torch.cuda.empty_cache()
    main = main_path_phase(torch, knn_cuda, smi, dev)
    loop, start, kinds, loop_cfg = loop_path_phase(torch, knn_cuda, smi, dev)
    methods = loop_methods_phase(torch, knn_cuda, smi, start, loop_cfg)
    fleet_run = fleet_phase(torch, knn_cuda, smi, dev)
    fleet_loop = fleet_loop_phase(torch, knn_cuda, smi, kinds, loop_cfg)
    del start, kinds
    fleet_chunks = fleet_chunk_phase(torch, knn_cuda, smi, dev)
    cli = cli_phase(torch, knn_cuda, smi)
    sharded = shard_phase(torch, knn_cuda, smi, dev, main)
    rbf = rbf_phase(torch, knn_cuda, smi, dev)
    registration = registration_phase(torch, knn_cuda, smi, dev)
    oracles = oracle_phase(torch, smi, dev)
    evals = eval_phase(torch, knn_cuda, smi, dev)
    roots = entry_bench_phase(torch, knn_cuda, smi, dev)

    # the kernel's calls on the paths (phases 4, 5, 5b, 6, 6b, 6c, 7, 8, 8b, 9, 10, 11),
    # counted by the wrapper at each shape; every such shape is one that
    # phase 3b timed
    paths = {"phase 4 (no loops)": main, "phase 5 (loops)": loop,
             **{f"phase 5b ({m})": r for m, r in methods.items()},
             f"phase 6 (fleet of {FLEET_B})": fleet_run, "phase 6b (fleet loop step, 3 robots)": fleet_loop,
             f"phase 6c (fleet of {FLEET_B}, loops, chunks of {FLEET_CHUNK})": fleet_chunks,
             "phase 7 (CLI: log, localize, bag)": cli,
             f"phase 8 (sharded step, {SHARD_RANKS} ranks)": sharded, "phase 8b (rbf)": rbf,
             "phase 9 (registration library)": registration,
             "phase 10 (evaluation programs)": evals,
             "phase 11 (graft entry, dry run, bench)": roots}
    path = Counter()
    for r in paths.values():
        path.update(r["launches_by_shape"])
    census = {"phase 4 (one steady scan)": main["sync_census"]["total"],
              "phase 5 (one loop step with ICP and its PGO)": loop["sync_census"]["total"],
              f"phase 6 (one fleet step of {FLEET_B} robots)": fleet_run["sync_census"]["total"]}
    print("host syncs (census): " + "; ".join(f"{k}: {n}" for k, n in census.items()))
    timed = {row["key"]: name for name, row in timings.items()}
    assert set(path) <= set(timed), f"shapes launched on a path but not timed: {set(path) - set(timed)}"
    total = sum(r["launches"] for r in paths.values())
    assert total == sum(path.values()), (total, path)
    shapes = [{"shape": name, "launches": path[key], "ms": timings[name]["kernel_ms"][0],
               "plain_ms": timings[name]["plain_ms"][0], "bound_ms": timings[name]["bound_ms"],
               "bound_by": timings[name]["bound_by"], "chunks": timings[name]["chunks"]}
              for key, name in timed.items()]
    surf = timings["surf 2048x32768 k=5"]
    record = {"kernels": [{
        "name": "knn",
        "route": "cuda",
        "source": "rgc_slam_tpu_torch/csrc/knn.cu",
        "replaces": "rgc_slam_tpu/ops/pallas/knn_kernel.py:92",
        "launches": total,
        "launches_by_path": {name: r["launches"] for name, r in paths.items()},
        "max_abs_err": max(max_err, batched_err),
        "ms": surf["kernel_ms"][0],
        "plain_ms": surf["plain_ms"][0],
        "bound_ms": surf["bound_ms"],
        "bound_by": surf["bound_by"],
        "library_ms": None,          # no one PyTorch call computes this function
        "chunks": surf["chunks"],
        "shapes": shapes,
    }]}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "torch": f"{torch.__version__} cuda {torch.version.cuda}",
                   "build_s": build_s, "registers_spills": regs, "plans": plans,
                   "timings": timings, "main_path": main, "loop_path": loop,
                   "loop_methods": methods, "fleet": fleet_run, "fleet_loop_step": fleet_loop,
                   "fleet_chunks": fleet_chunks, "cli": cli, "sharded": sharded, "rbf": rbf,
                   "registration": registration, "oracles": oracles, "evals": evals,
                   "roots": roots, "record": record}, f, indent=1)
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
