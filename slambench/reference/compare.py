"""The comparison that decides ``correct``: each sampled call's stages
worked out again by the reference (``stages.py``) from the program's state
around the call and the inputs the benchmark handed over.

Per sampled call: ``map_pos_m`` and ``map_rot_rad``, the gaps of the map
pose the call returned to the reference's associations and 12-dim solve
from the same start; ``keyframe_mismatch``, 1 where the keyframe store did
not do what the decision on the returned pose asks; and, printed but not
compared, the ground plane's ``ground_dist_m`` and ``ground_angle_rad``
(TF32 and an honest float32 summation read alike there, PERF.md §2).  The
ground stage is worked out only where the configuration's ``use_ground``
is true; elsewhere the program's plane feeds nothing, and its gaps read
None (null).

Numbers compared: ``map_pos_med_m`` and ``map_rot_med_rad``, the medians
of the pose gaps over the sampled calls, and the largest
``keyframe_mismatch``.  The median, not the widest gap: the association's
gates and nearest neighbours are thresholds, and a float32 program flips
one now and then where the float64 reference does not, which moves that
call's pose by up to 3e-4 m (PERF.md §2), while a lower precision moves
every call.

The reference runs in float64; ``calibrate.py`` also runs it in float32 (a
witness of an honest float32 program) and in TF32 (the control), each put
in the program's place.  Nothing here imports the program: a call arrives
as a dict of tensors (``drivers/slam_system.py``'s ``view``).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

from . import stages
from .precision import PRECISIONS

NUMBERS = ("map_pos_med_m", "map_rot_med_rad", "keyframe_mismatch")
# printed beside them, not compared
DIAGNOSTIC = ("map_pos_max_m", "map_rot_max_rad", "ground_dist_max_m", "ground_angle_max_rad")
SETTINGS = ("n_scans", "minimum_range", "maximum_range", "lidar_height", "max_points",
            "max_points_per_ring", "ground_scan_rings", "ground_z_max", "ground_range_gate",
            "use_ground", "use_imu", "map_update", "keyframe_dist", "keyframe_angle",
            "surrounding_radius", "surrounding_keyframes", "map_corner_voxel", "map_surf_voxel",
            "map_opt_iterations")
# settings whose other values take paths the reference does not follow
FIXED = {"mapping_skip_frame": 1, "mapping_loss": "huber", "map_knn": 5, "degeneracy_thresh": 0.0}


def settings(slam_config: dict) -> dict:
    """The configuration's settings the reference reads, all stated in its
    file; a setting the reference does not follow is refused."""
    missing = [k for k in SETTINGS + tuple(FIXED) if k not in slam_config]
    if missing:
        raise ValueError(f"the configuration does not state {missing}")
    off = {k: slam_config[k] for k, v in FIXED.items() if slam_config[k] != v}
    if off:
        raise ValueError(f"the reference follows only {FIXED}; the configuration has {off}")
    if slam_config["use_ground"] and slam_config["n_scans"] != 16:
        raise ValueError(f"the reference's ground stage knows the VLP-16's ring table only: "
                         f"use_ground true needs n_scans 16, the configuration has n_scans "
                         f"{slam_config['n_scans']}")
    return {k: slam_config[k] for k in SETTINGS}


class Numbers(dict):
    """``summary``'s numbers: a diagnostic that no sampled call has (the
    ground gaps where ``use_ground`` is off) is left out, and reads None."""

    def __missing__(self, key):
        if key in DIAGNOSTIC:
            return None
        raise KeyError(key)


def _worst(x: float) -> float:
    return math.inf if x != x else float(x)         # NaN reads as the worst gap


def reference(call: Dict[str, object], cfg: dict, prec_name: str) -> Dict[str, object]:
    """One call's stages worked out in a precision."""
    prec = PRECISIONS[prec_name]
    return {"ground": stages.ground(call["scan"], cfg, prec) if cfg["use_ground"] else None,
            "mapping": stages.mapping(call, cfg, prec)}


def _ground_gaps(program: Dict[str, object], ref: Dict[str, object]) -> Dict[str, object]:
    """The plane's gaps, or None for both where the reference has none."""
    if ref is None:
        return {"ground_angle_rad": None, "ground_dist_m": None}
    g_ang, g_dist = stages.plane_gaps(program, ref)
    return {"ground_angle_rad": _worst(g_ang), "ground_dist_m": _worst(g_dist)}


def row(call: Dict[str, object], ref: Dict[str, object], cfg: dict) -> Dict[str, float]:
    """The program's numbers on one call against the reference's."""
    a = call["after"]["ground_last"]
    prog_plane = {"valid": bool(a["valid"]), "normal": a["normal"].double().cpu().numpy(),
                  "distance": float(a["distance"])}
    pos, rot = stages.pose_gaps(call["q_map"], call["t_map"], ref["mapping"])
    return {**_ground_gaps(prog_plane, ref["ground"]),
            "map_pos_m": _worst(pos), "map_rot_rad": _worst(rot),
            "keyframe_mismatch": float(stages.keyframe_mismatch(call, cfg)), "i": call["i"]}


def stand_in_row(call: Dict[str, object], other: Dict[str, object], ref: Dict[str, object],
                 cfg: dict) -> Dict[str, float]:
    """The numbers of ``other`` (the reference in another precision) put in
    the program's place on one call: its plane and pose against the
    reference's, and its keyframe decision against the reference's."""
    m, r = other["mapping"], ref["mapping"]
    pos, rot = stages.pose_gaps(stages.wxyz(m["q"]), m["t"], r)
    kf = (stages.keyframe_added(m["q"].double(), m["t"].double(), call["before"], cfg)
          != stages.keyframe_added(r["q"].double(), r["t"].double(), call["before"], cfg))
    return {**_ground_gaps(other["ground"], ref["ground"]),
            "map_pos_m": _worst(pos), "map_rot_rad": _worst(rot),
            "keyframe_mismatch": float(kf), "i": call["i"]}


def summary(rows: List[Dict[str, float]]) -> Numbers:
    """The numbers compared, and the diagnostics, over the sampled calls."""
    def col(k):
        return [_worst(r[k]) for r in rows] or [0.0]

    out = Numbers({"map_pos_med_m": statistics.median(col("map_pos_m")),
                   "map_rot_med_rad": statistics.median(col("map_rot_rad")),
                   "keyframe_mismatch": max(col("keyframe_mismatch")),
                   "map_pos_max_m": max(col("map_pos_m")),
                   "map_rot_max_rad": max(col("map_rot_rad"))})
    for k, per_call in (("ground_dist_max_m", "ground_dist_m"),
                        ("ground_angle_max_rad", "ground_angle_rad")):
        seen = [r[per_call] for r in rows if r[per_call] is not None]
        if seen or not rows:
            out[k] = max(seen or [0.0])
    return out


def failed_calls(rows: List[Dict[str, float]], numbers: Dict[str, float],
                 limits: Dict[str, float]) -> int:
    """The sampled calls that fail: each with a keyframe mismatch, and,
    where a median is over its limit, each whose gap is over it too."""
    over = {k for k in ("map_pos_med_m", "map_rot_med_rad") if numbers[k] > limits[k]}
    per_call = {"map_pos_med_m": "map_pos_m", "map_rot_med_rad": "map_rot_rad"}
    return sum(r["keyframe_mismatch"] > limits["keyframe_mismatch"]
               or any(_worst(r[per_call[k]]) > limits[k] for k in over) for r in rows)
