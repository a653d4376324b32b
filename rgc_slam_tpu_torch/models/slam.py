"""The SLAM engine: the port of ``rgc_slam_tpu/models/slam.py``.

``slam_step(state, cloud, imu, stamp, cfg) -> (state, outputs)`` runs
features -> odometry -> feature voxel downsampling -> mapping for one scan
over an explicit state of tensors.  ``SlamSystem`` is the host driver that
owns the state on its device, feeds scans, runs loop closure + 4-DoF PGO
(``models/loop.py``) every ``cfg.loop_cadence`` scans and keeps the
trajectories; it also advances a chunk of scans per call
(``make_chunk_step``, ``SlamSystem.process_chunk``) and checkpoints the
session (``utils/checkpoint``).  ``slam_step`` reads nothing on the host,
so on the card ``SlamSystem`` runs it as one captured CUDA graph per step
or chunk (``utils/graph``), where the JAX package runs its jitted program.

``slam_step`` marks the ends of its stages (``utils.graph.mark``:
``features``, ``odometry_pre``, ``vgicp_lm``, ``odometry_post``,
``downsample``, ``mapping``), which a traced capture times on the card, and
returns the VGICP LM's iteration counts (``SlamOutput.lm_iters``);
``SlamSystem`` records each call in ``utils.profiling.tracer``.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..types import ImuBatch, PointCloud, Struct, tree_where
from ..ops import features as F
from ..ops import voxelhash as vh
from ..ops.cuda import map_lm as map_lm_cuda
from ..utils import checkpoint, evaluation, graph, profiling
from ..utils import math3d as m3
from . import loop as loop_mod
from . import mapping as mapping_mod
from . import odometry as odometry_mod


@dataclass
class SlamState(Struct):
    odo: odometry_mod.OdometryState
    mapping: mapping_mod.MappingState

    @classmethod
    def init(cls, cfg: SlamConfig, device, dtype=torch.float32) -> "SlamState":
        return cls(
            odo=odometry_mod.OdometryState.init(cfg, device, dtype),
            mapping=mapping_mod.MappingState.init(cfg, device, dtype),
        )


class SlamOutput(NamedTuple):
    q_odom: torch.Tensor
    t_odom: torch.Tensor
    q_map: torch.Tensor
    t_map: torch.Tensor
    fitness: torch.Tensor
    n_corr: torch.Tensor
    kf_added: torch.Tensor
    full_xyz: torch.Tensor    # deskewed full cloud (sensor frame)
    full_mask: torch.Tensor
    lm_iters: torch.Tensor    # int32 [3]: the VGICP LM's outer and inner iterations, bodies run


def slam_step(state: SlamState, cloud: PointCloud, imu: ImuBatch, stamp: torch.Tensor,
              cfg: SlamConfig):
    """features -> odometry -> mapping, one scan."""
    if cfg.sp_features and cfg.psum_axis is not None and cfg.sp_shards > 1:
        # the block-sharded front-end on an sp mesh (a static choice: the
        # default path is unchanged)
        fx = F.extract_features_sp(cloud, cfg)
    else:
        fx = F.extract_features(cloud, cfg)
    graph.mark("features")
    odo_state, odo_out = odometry_mod.odometry_step(state.odo, fx, imu, stamp, cfg)
    graph.mark("odometry_post")

    # current-frame feature clouds for mapping: corner at the line
    # resolution, surf at the plane resolution, confidences voxel-averaged
    c_xyz, c_mask, (c_conf,) = vh.voxel_downsample(
        odo_out.deskewed_sharp_xyz, fx.sharp.mask, cfg.map_corner_voxel,
        cfg.max_kf_corner, extras=(fx.sharp.confidence,), probes=cfg.hash_probes,
    )
    s_xyz, s_mask, (s_conf,) = vh.voxel_downsample(
        odo_out.deskewed_flat_xyz, fx.flat.mask, cfg.map_surf_voxel,
        cfg.max_kf_surf, extras=(fx.flat.confidence,), probes=cfg.hash_probes,
    )
    graph.mark("downsample")
    f = odo_state.imu_filter
    imu_ypr = torch.stack([f.yaw, f.pitch, f.roll])

    map_state, map_out = mapping_mod.mapping_step(
        state.mapping, odo_out, c_xyz, c_conf, c_mask, s_xyz, s_conf, s_mask,
        imu_ypr, stamp, cfg,
    )
    if cfg.mapping_skip_frame > 1:
        # rate decoupling: skipped scans reuse the map->odom correction.
        # The JAX package's lax.cond as vmap makes it: mapping runs every
        # scan and a skipped scan takes the other branch's result, so the
        # host reads nothing
        skip = torch.remainder(state.odo.frame, cfg.mapping_skip_frame) != 0
        ms = state.mapping
        zero_i = torch.zeros((), dtype=torch.int32, device=stamp.device)
        skipped = (ms, mapping_mod.MappingOutput(
            q_w=m3.quat_normalize(m3.quat_mul(ms.q_md, odo_out.q_w)),
            t_w=ms.t_md + m3.quat_rotate(ms.q_md, odo_out.t_w),
            q_md=ms.q_md, t_md=ms.t_md,
            kf_added=torch.zeros((), dtype=torch.bool, device=stamp.device),
            n_corner_factors=zero_i, n_surf_factors=zero_i,
        ))
        map_state, map_out = tree_where(skip, skipped, (map_state, map_out))
    graph.mark("mapping")

    out = SlamOutput(
        q_odom=odo_out.q_w, t_odom=odo_out.t_w, q_map=map_out.q_w, t_map=map_out.t_w,
        fitness=odo_out.fitness, n_corr=odo_out.n_corr, kf_added=map_out.kf_added,
        full_xyz=odo_out.deskewed_full.xyz, full_mask=odo_out.deskewed_full.mask,
        lm_iters=odo_out.lm_iters,
    )
    return SlamState(odo=odo_state, mapping=map_state), out


def make_chunk_step(step_fn, chunk: int):
    """Compile a program advancing ``chunk`` scans per call: the JAX
    function's signature, ``(state, *flat) -> (state, [out] * chunk)``,
    where flat interleaves chunk (cloud, imu, stamp) triples and
    ``step_fn(state, cloud, imu, stamp) -> (state, out)`` reads nothing on
    the host.  On the card the chunk's steps are captured into one CUDA
    graph and replayed per call (``utils.graph.CompiledStep``, the
    counterpart of the JAX function's ``jax.jit``); on the CPU they run one
    after another.  Either way a chunk's results equal ``chunk`` single
    steps.  Shared by ``SlamSystem.process_chunk``, the fleet CLI and
    ``tools.bench``."""

    def chunk_step(state, *flat):
        outs = []
        for i in range(chunk):
            state, out = step_fn(state, *flat[3 * i:3 * i + 3])
            outs.append(out)
        return state, outs

    return graph.CompiledStep(chunk_step)


class SlamSystem:
    """The host side of ``slam_step`` and the loop-closure step on one
    device.

    ``device`` is the card unless the caller passes ``device="cpu"``; on a
    machine without CUDA the default raises, and nothing falls back to the
    CPU.  ``process`` advances one scan and records the map and odometry
    trajectories; with ``enable_loop`` (default: ``cfg.loop_closure_enable``)
    it also runs ``loop.loop_closure_step`` on ``self.loop_state`` after
    every ``cfg.loop_cadence``-th scan (``loop_step``), as the JAX
    package's ``SlamSystem`` does, and keeps its ``LoopInfo`` in
    ``self.loop_info`` (None after a scan that ran no loop step).

    On the card ``process`` replays ``slam_step`` as one captured CUDA
    graph (``utils.graph``), as the JAX package always runs its jitted
    step; ``self.state`` is a fresh state after every scan, and a state
    assigned to it (a loop step's, ``load``'s) is copied into the graph's
    static buffers at the next scan.

    With ``trace`` (the default) every ``process`` / ``process_chunk`` is a
    call of ``utils.profiling.tracer`` (its id the scan counter): host spans
    ``process`` (or ``process_chunk``), ``copy_in`` / ``launch`` / ``clone``
    (``utils.graph``), ``pose_read``, ``loop_step`` and the loop step's own
    (``models.loop``), the device ms of the graph's stages, and the VGICP
    LM's iterations, copied to pinned host memory without a wait and read
    after the pose read, and ``map_lm_evals``, the mapping LM's kernel
    evaluations the call launched or replayed (``ops/cuda/map_lm``; 0 on
    the autodiff route).  ``trace=False`` captures no events and records
    nothing.

    ``chunk`` > 1 enables ``process_chunk``, which advances ``chunk`` scans
    in one call (one graph of the chunk); it is rejected, as in the JAX package,
    when a chunk could add keyframes past the eviction headroom or delay a
    loop step past it.  ``save`` / ``load`` checkpoint the session and
    ``dump_tum`` writes the trajectories."""

    def __init__(self, cfg: SlamConfig, enable_loop: Optional[bool] = None, chunk: int = 1,
                 device="cuda", trace: bool = True):
        self.enable_loop = cfg.loop_closure_enable if enable_loop is None else enable_loop
        if chunk > 1:
            if chunk > mapping_mod.COMPACT_MARGIN:
                # eviction runs between calls (loop_closure_step / inline);
                # a longer chunk could drop keyframes past capacity mid-chunk
                raise ValueError(
                    f"chunk={chunk} exceeds the keyframe-eviction headroom "
                    f"(COMPACT_MARGIN={mapping_mod.COMPACT_MARGIN}); keyframes "
                    f"added past capacity inside one dispatch would be "
                    f"silently dropped"
                )
            gap = mapping_mod.worst_cadence_gap(cfg.loop_cadence, chunk)
            if self.enable_loop and gap > mapping_mod.COMPACT_MARGIN:
                # loop steps (and the loop-aware compaction) run only at
                # chunk boundaries, up to chunk-1 scans late
                raise ValueError(
                    f"chunk={chunk} with loop_cadence={cfg.loop_cadence}: "
                    f"loop/compaction opportunities come only at chunk "
                    f"boundaries — worst-case gap {gap} scans exceeds the "
                    f"keyframe-eviction headroom "
                    f"(COMPACT_MARGIN={mapping_mod.COMPACT_MARGIN}); pick a "
                    f"chunk dividing loop_cadence or a smaller chunk"
                )
        self.cfg = cfg
        self.chunk = chunk
        self.device = torch.device(device)
        self.state = SlamState.init(cfg, self.device)
        self.loop_state = loop_mod.LoopState.init(cfg, self.device) if self.enable_loop else None
        self.trace = trace
        self._step = graph.CompiledStep(functools.partial(slam_step, cfg=cfg))
        self._chunk_step = (make_chunk_step(functools.partial(slam_step, cfg=cfg), chunk)
                            if chunk > 1 else None)
        # the LM counts of a call's scans, copied here before its pose read
        self._lm_host = (torch.zeros((chunk, 3), dtype=torch.int32,
                                     pin_memory=self.device.type == "cuda") if trace else None)
        self.trajectory = []          # (stamp, q_map, t_map)
        self.odom_trajectory = []
        self.loop_info: Optional[loop_mod.LoopInfo] = None
        self._frame = 0

    def _stamp(self, stamp: float) -> torch.Tensor:
        return torch.tensor(stamp, dtype=torch.float32, device=self.device)

    def _record(self, stamp: float, out: SlamOutput):
        with profiling.tracer.span("pose_read"):
            self.trajectory.append((stamp, out.q_map.cpu().numpy(), out.t_map.cpu().numpy()))
            self.odom_trajectory.append((stamp, out.q_odom.cpu().numpy(),
                                         out.t_odom.cpu().numpy()))

    def _call(self, name: str):
        """The tracer's call of this scan counter, or nothing untraced."""
        return profiling.tracer.call(self._frame, name) if self.trace else contextlib.nullcontext()

    def _trace_lm(self, outs, map_lm_evals: int):
        """Queue the copy of each scan's LM counts to pinned host memory
        (no wait); the call's record adds them up when the call returns,
        after the pose read has waited for the copy.  ``map_lm_evals``, the
        mapping LM kernel's evaluations the call ran, is known on the host
        already."""
        if not self.trace:
            return
        for row, out in zip(self._lm_host, outs):
            row.copy_(out.lm_iters, non_blocking=True)
        rec = profiling.tracer.current
        rec.scans = len(outs)
        rec.counters["map_lm_evals"] = map_lm_evals
        profiling.tracer.defer(self._count_lm)

    def _count_lm(self, rec):
        outer, inner, bodies = self._lm_host[:rec.scans].sum(0).tolist()
        rec.counters.update(lm_outer=outer, lm_inner=inner, lm_inner_static=rec.scans * (
            self.cfg.vgicp_max_iterations * self.cfg.lm_max_inner), lm_bodies_run=bodies)

    def process(self, cloud: PointCloud, imu: ImuBatch, stamp: float) -> SlamOutput:
        with self._call("process"):
            evals = map_lm_cuda.evaluations()
            self.state, out = self._step(self.state, cloud, imu, self._stamp(stamp))
            self._trace_lm((out,), map_lm_cuda.evaluations() - evals)
            self._record(stamp, out)
            self._frame += 1
            self.loop_info = None
            # the reference's 1 Hz pose-graph thread: every cfg.loop_cadence scans
            if self.enable_loop and self._frame % self.cfg.loop_cadence == 0:
                self.loop_info = self.loop_step()
        return out

    def process_chunk(self, items):
        """Advance ``len(items)`` scans in one call; needs ``chunk`` > 1 at
        construction and ``len(items) == chunk`` (feed a final partial chunk
        through ``process``).  items: [(cloud, imu, stamp), ...].  The
        trajectory is recorded per scan; the loop steps due in the chunk
        (one per ``cfg.loop_cadence`` boundary crossed) run after it, at the
        chunk boundary, and ``self.loop_info`` holds the last one's
        ``LoopInfo`` (None if none ran)."""
        if self._chunk_step is None or len(items) != self.chunk:
            raise ValueError(f"process_chunk takes exactly chunk={self.chunk} > 1 items, "
                             f"got {len(items)}")
        flat = [x for (cloud, imu, stamp) in items for x in (cloud, imu, self._stamp(stamp))]
        with self._call("process_chunk"):
            evals = map_lm_cuda.evaluations()
            self.state, outs = self._chunk_step(self.state, *flat)
            self._trace_lm(outs, map_lm_cuda.evaluations() - evals)
            lc = self.cfg.loop_cadence
            loops_due = (self._frame + self.chunk) // lc - self._frame // lc
            self._frame += self.chunk
            for (_, _, stamp), out in zip(items, outs):
                self._record(stamp, out)
            self.loop_info = None
            if self.enable_loop:
                for _ in range(loops_due):
                    self.loop_info = self.loop_step()
        return outs

    def loop_step(self) -> loop_mod.LoopInfo:
        """One loop-closure opportunity on the held state, as ``process``
        runs it every ``cfg.loop_cadence`` scans: updates ``self.state``
        and ``self.loop_state`` and returns the step's ``LoopInfo``."""
        with profiling.tracer.span("loop_step") as rec:
            self.state, self.loop_state, info = loop_mod.loop_closure_step(
                self.state, self.loop_state, self.cfg)
        if rec is not None:
            rec.loop = True
        return info

    def _payload(self):
        return (self.state, self.loop_state) if self.enable_loop else (self.state,)

    def save(self, path: str):
        """Checkpoint the session: ``(state,)`` or ``(state, loop_state)``
        and the scan counter (``utils/checkpoint``)."""
        checkpoint.save(path, self._payload(), step=self._frame, cfg=self.cfg)

    def load(self, path: str):
        restored, step = checkpoint.restore(path, self._payload(), self.device)
        if self.enable_loop:
            self.state, self.loop_state = restored
        else:
            (self.state,) = restored
        self._frame = step

    def dump_tum(self, path: str, which: str = "map"):
        traj = self.trajectory if which == "map" else self.odom_trajectory
        evaluation.dump_tum(
            path, [s for s, _, _ in traj], [t for _, _, t in traj], [q for _, q, _ in traj]
        )


def trajectory_xyz(system: SlamSystem) -> np.ndarray:
    """[T, 3] map-frame positions recorded by ``system.process``."""
    return np.stack([t for _, _, t in system.trajectory])
