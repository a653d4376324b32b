"""GNSS frontend (SURVEY A7, RGC_odometer.cpp:488-541,718-799).

The reference converts NavSatFix (RTK and plain GPS) to local metric XYZ with
an equirectangular projection anchored at the first fix and publishes the
resulting paths as ground-truth comparison tracks; the fixes are **not fused**
into the estimator.  Same role here: convert, accumulate, and hand the tracks
to the evaluation layer (utils/evaluation compares them against the SLAM
trajectory like the reference's evo workflow).

A copy of ``rgc_slam_tpu/io/gnss.py``, kept in the port so that it
imports nothing of the JAX package; ``tests/test_torch_parity_copies.py``
holds the two to the same results.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

R_EARTH = 6371393.0          # meters (the reference's R_EARTH constant)
DEG2RAD = np.pi / 180.0


@dataclasses.dataclass
class GnssFix:
    t: float
    latitude: float          # degrees
    longitude: float         # degrees
    altitude: float          # meters
    covariance: Optional[np.ndarray] = None   # [9] position covariance
    status: int = 0


def gnss_to_xyz(fix: GnssFix, anchor: GnssFix) -> np.ndarray:
    """Equirectangular lat/lon/alt -> local XYZ (ref ``GPS_to_XYZ``):
    x = dlon * R cos(lat) ; y = dlat * R ; z = dalt  (all in meters)."""
    dlon = fix.longitude - anchor.longitude
    dlat = fix.latitude - anchor.latitude
    return np.array(
        [
            dlon * R_EARTH * np.cos(fix.latitude * DEG2RAD) * DEG2RAD,
            dlat * R_EARTH * DEG2RAD,
            fix.altitude - anchor.altitude,
        ]
    )


class GnssTrack:
    """Accumulates fixes into a local-frame path (the reference's RTK/GPS
    path publishers, minus ROS)."""

    def __init__(self):
        self.anchor: Optional[GnssFix] = None
        self.stamps: List[float] = []
        self.xyz: List[np.ndarray] = []

    def push(self, fix: GnssFix) -> np.ndarray:
        if self.anchor is None:
            self.anchor = fix
        p = gnss_to_xyz(fix, self.anchor)
        self.stamps.append(fix.t)
        self.xyz.append(p)
        return p

    def as_arrays(self):
        return np.asarray(self.stamps), np.stack(self.xyz) if self.xyz else np.zeros((0, 3))

    def dump_tum(self, path: str):
        from ..utils.evaluation import dump_tum

        n = len(self.stamps)
        dump_tum(
            path, self.stamps, self.xyz, [np.array([1.0, 0, 0, 0])] * n
        )
