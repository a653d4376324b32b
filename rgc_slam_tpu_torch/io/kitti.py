"""KITTI odometry dataset ingestion: the port of ``rgc_slam_tpu/io/kitti.py``.

KITTI velodyne scans are headerless float32 ``[N, 4]`` (x, y, z, reflectance)
files from an HDL-64E with no ring channel and no IMU; the reference handles
them through its 64-beam vertical-angle binning (scanRegistration.cpp:163-178)
with ``USE_IMU=0``.  Same here: ring ids and sweep fractions are recovered
geometrically (``io/convert``), and the engine runs with
``use_imu=False, use_ground=False, n_scans=64``.  Clouds land on the
caller's ``device``.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

from ..config import SlamConfig
from ..types import ImuBatch, PointCloud
from .convert import cloud_from_arrays, rel_time_from_azimuth, ring_from_vertical_angle

KITTI_CONFIG_OVERRIDES = dict(
    n_scans=64,
    use_imu=False,
    use_ground=False,
    max_points=131072,        # HDL-64E ~120k returns
    lidar_height=1.73,        # KITTI velodyne mount height
)


def kitti_config(**extra) -> SlamConfig:
    kw = dict(KITTI_CONFIG_OVERRIDES)
    kw.update(extra)
    return SlamConfig(**kw)


def read_velodyne_bin(path: str) -> np.ndarray:
    """One KITTI scan file -> [N, 4] float32 (x, y, z, reflectance)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def scan_to_cloud(raw: np.ndarray, cfg: SlamConfig, device) -> PointCloud:
    """Raw KITTI points -> engine PointCloud (ring + rel_time recovered)."""
    xyz = raw[:, :3]
    ring, valid = ring_from_vertical_angle(xyz, cfg.n_scans)
    rel = rel_time_from_azimuth(xyz)
    inten = raw[:, 3] * 255.0      # KITTI reflectance in [0,1]
    return cloud_from_arrays(xyz, inten, ring, rel, valid, cfg.max_points, device)


class KittiSequence:
    """Iterates a KITTI odometry sequence directory (velodyne/*.bin)."""

    def __init__(self, velodyne_dir: str, cfg: Optional[SlamConfig] = None,
                 rate_hz: float = 10.0, device="cuda"):
        self.cfg = cfg or kitti_config()
        self.files: List[str] = sorted(
            os.path.join(velodyne_dir, f) for f in os.listdir(velodyne_dir) if f.endswith(".bin")
        )
        self.rate = rate_hz
        self.device = device

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[dict]:
        empty_imu = ImuBatch.zeros(self.cfg.max_imu, self.device)
        for k, path in enumerate(self.files):
            raw = read_velodyne_bin(path)
            yield {
                "cloud": scan_to_cloud(raw, self.cfg, self.device),
                "imu": empty_imu,
                "stamp": (k + 1) / self.rate,
            }


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI ground-truth pose file -> [N, 3, 4] cam0 poses."""
    return np.loadtxt(path).reshape(-1, 3, 4)
