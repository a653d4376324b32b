"""The SLAM engine: the port of ``rgc_slam_tpu/models/slam.py``.

``slam_step(state, cloud, imu, stamp, cfg) -> (state, outputs)`` runs
features -> odometry -> feature voxel downsampling -> mapping for one scan
over an explicit state of tensors.  ``SlamSystem`` is the host driver that
owns the state on its device, feeds scans, runs loop closure + 4-DoF PGO
(``models/loop.py``) every ``cfg.loop_cadence`` scans and keeps the
trajectories; it also advances a chunk of scans per call
(``make_chunk_step``, ``SlamSystem.process_chunk``) and checkpoints the
session (``utils/checkpoint``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..types import ImuBatch, PointCloud, Struct, tree_where
from ..ops import features as F
from ..ops import voxelhash as vh
from ..utils import checkpoint, evaluation
from ..utils import math3d as m3
from ..utils.lanes import any_lane
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


def slam_step(state: SlamState, cloud: PointCloud, imu: ImuBatch, stamp: torch.Tensor,
              cfg: SlamConfig):
    """features -> odometry -> mapping, one scan."""
    if cfg.sp_features and cfg.psum_axis is not None and cfg.sp_shards > 1:
        # the block-sharded front-end on an sp mesh (a static choice: the
        # default path is unchanged)
        fx = F.extract_features_sp(cloud, cfg)
    else:
        fx = F.extract_features(cloud, cfg)
    odo_state, odo_out = odometry_mod.odometry_step(state.odo, fx, imu, stamp, cfg)

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
    f = odo_state.imu_filter
    imu_ypr = torch.stack([f.yaw, f.pitch, f.roll])

    def run_mapping():
        return mapping_mod.mapping_step(
            state.mapping, odo_out, c_xyz, c_conf, c_mask, s_xyz, s_conf, s_mask,
            imu_ypr, stamp, cfg,
        )

    if cfg.mapping_skip_frame > 1:
        # rate decoupling: skipped scans reuse the map->odom correction.
        # The JAX package's lax.cond: mapping runs when some lane maps this
        # scan, and each lane takes its own branch's result.
        skip = torch.remainder(state.odo.frame, cfg.mapping_skip_frame) != 0
        ms = state.mapping
        skipped = (ms, mapping_mod.MappingOutput(
            q_w=m3.quat_normalize(m3.quat_mul(ms.q_md, odo_out.q_w)),
            t_w=ms.t_md + m3.quat_rotate(ms.q_md, odo_out.t_w),
            q_md=ms.q_md, t_md=ms.t_md,
            kf_added=torch.tensor(False, device=stamp.device),
            n_corner_factors=torch.tensor(0, dtype=torch.int32, device=stamp.device),
            n_surf_factors=torch.tensor(0, dtype=torch.int32, device=stamp.device),
        ))
        map_state, map_out = (tree_where(skip, skipped, run_mapping())
                              if bool(any_lane(~skip)) else skipped)
    else:
        map_state, map_out = run_mapping()

    out = SlamOutput(
        q_odom=odo_out.q_w, t_odom=odo_out.t_w, q_map=map_out.q_w, t_map=map_out.t_w,
        fitness=odo_out.fitness, n_corr=odo_out.n_corr, kf_added=map_out.kf_added,
        full_xyz=odo_out.deskewed_full.xyz, full_mask=odo_out.deskewed_full.mask,
    )
    return SlamState(odo=odo_state, mapping=map_state), out


def make_chunk_step(step_fn, chunk: int):
    """A callable advancing ``chunk`` scans per call: the JAX function's
    signature, ``(state, *flat) -> (state, [out] * chunk)``, where flat
    interleaves chunk (cloud, imu, stamp) triples and ``step_fn(state,
    cloud, imu, stamp) -> (state, out)``.  The steps run one after another
    (no program is compiled: the JAX function's ``jax.jit`` has no
    counterpart here), so a chunk's results equal ``chunk`` single steps.
    Shared by ``SlamSystem.process_chunk`` and the fleet CLI."""

    def chunk_step(state, *flat):
        outs = []
        for i in range(chunk):
            state, out = step_fn(state, *flat[3 * i:3 * i + 3])
            outs.append(out)
        return state, outs

    return chunk_step


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

    ``chunk`` > 1 enables ``process_chunk``, which advances ``chunk`` scans
    in one call (buffered replay); it is rejected, as in the JAX package,
    when a chunk could add keyframes past the eviction headroom or delay a
    loop step past it.  ``save`` / ``load`` checkpoint the session and
    ``dump_tum`` writes the trajectories."""

    def __init__(self, cfg: SlamConfig, enable_loop: Optional[bool] = None, chunk: int = 1,
                 device="cuda"):
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
        self._chunk_step = (make_chunk_step(functools.partial(slam_step, cfg=cfg), chunk)
                            if chunk > 1 else None)
        self.trajectory = []          # (stamp, q_map, t_map)
        self.odom_trajectory = []
        self.loop_info: Optional[loop_mod.LoopInfo] = None
        self._frame = 0

    def _stamp(self, stamp: float) -> torch.Tensor:
        return torch.tensor(stamp, dtype=torch.float32, device=self.device)

    def _record(self, stamp: float, out: SlamOutput):
        self.trajectory.append((stamp, out.q_map.cpu().numpy(), out.t_map.cpu().numpy()))
        self.odom_trajectory.append((stamp, out.q_odom.cpu().numpy(), out.t_odom.cpu().numpy()))

    def process(self, cloud: PointCloud, imu: ImuBatch, stamp: float) -> SlamOutput:
        self.state, out = slam_step(self.state, cloud, imu, self._stamp(stamp), self.cfg)
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
        self.state, outs = self._chunk_step(self.state, *flat)
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
        self.state, self.loop_state, info = loop_mod.loop_closure_step(
            self.state, self.loop_state, self.cfg)
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
