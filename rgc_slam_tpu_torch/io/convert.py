"""Host-side converters: raw scan dicts / arrays -> padded tensors on a device.

The port of ``rgc_slam_tpu/io/convert.py``'s ``cloud_from_arrays``,
``cloud_from_scan_dict`` and ``imu_from_interval``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig
from ..types import ImuBatch, PointCloud


def cloud_from_arrays(
    xyz: np.ndarray,
    intensity: np.ndarray,
    ring: np.ndarray,
    rel_time: np.ndarray,
    mask: np.ndarray,
    cap: int,
    device,
) -> PointCloud:
    """Pack host arrays into a fixed-capacity PointCloud (truncate/pad).
    Truncation keeps valid points first, in their original order."""
    n = xyz.shape[0]
    order = np.argsort(~mask, kind="stable")[:cap] if n > cap else slice(None)

    def pad(a, fill=0):
        out = np.full((cap,) + a.shape[1:], fill, a.dtype)
        sel = a[order]
        out[: len(sel)] = sel
        return torch.from_numpy(out).to(device)

    return PointCloud(
        xyz=pad(xyz.astype(np.float32)),
        intensity=pad(intensity.astype(np.float32)),
        rel_time=pad(rel_time.astype(np.float32)),
        ring=pad(ring.astype(np.int32)),
        mask=pad(mask.astype(bool), fill=False),
    )


def cloud_from_scan_dict(scan: dict, cfg: SlamConfig, device) -> PointCloud:
    return cloud_from_arrays(
        scan["xyz"], scan["intensity"], scan["ring"], scan["rel_time"],
        scan["mask"], cfg.max_points, device,
    )


def imu_from_interval(t: np.ndarray, acc: np.ndarray, gyr: np.ndarray, cap: int,
                      device) -> ImuBatch:
    m = min(len(t), cap)
    T = np.zeros(cap, np.float32)
    A = np.zeros((cap, 3), np.float32)
    G = np.zeros((cap, 3), np.float32)
    M = np.zeros(cap, bool)
    T[:m], A[:m], G[:m], M[:m] = t[:m], acc[:m], gyr[:m], True
    return ImuBatch(
        t=torch.from_numpy(T).to(device), acc=torch.from_numpy(A).to(device),
        gyr=torch.from_numpy(G).to(device), mask=torch.from_numpy(M).to(device),
    )
