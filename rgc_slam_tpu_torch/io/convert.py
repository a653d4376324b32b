"""Host-side converters: raw scan dicts / arrays -> padded tensors on a device.

The port of ``rgc_slam_tpu/io/convert.py``'s ``cloud_from_arrays``,
``cloud_from_scan_dict`` and ``imu_from_interval``; its numpy-only
``ring_from_vertical_angle`` and ``rel_time_from_azimuth`` (the rosbag and
KITTI sources' channel fallbacks) are copies, held to the originals' arrays
by ``tests/test_torch_io.py``.
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


def ring_from_vertical_angle(xyz: np.ndarray, n_scans: int):
    """Ring id from the vertical angle for sensors without a ring channel
    (KITTI HDL-64E etc.) — the 16/32/64-beam binning formulas of
    scanRegistration.cpp:145-178.  Returns (ring, valid)."""
    angle = np.degrees(
        np.arctan2(xyz[:, 2], np.linalg.norm(xyz[:, :2], axis=1) + 1e-12)
    )
    if n_scans == 16:
        ring = np.floor((angle + 15.0) / 2.0 + 0.5).astype(np.int32)
        valid = (ring >= 0) & (ring < 16)
    elif n_scans == 32:
        ring = np.floor((angle + 92.0 / 3.0) * 3.0 / 4.0).astype(np.int32)
        valid = (ring >= 0) & (ring < 32)
    elif n_scans == 64:
        upper = angle >= -8.83
        ring = np.where(
            upper,
            np.floor((2.0 - angle) * 3.0 + 0.5),
            64 / 2 + np.floor((-8.83 - angle) * 2.0 + 0.5),
        ).astype(np.int32)
        valid = (angle <= 2.0) & (angle >= -24.33) & (ring >= 0) & (ring <= 50)
    else:
        raise ValueError("only 16/32/64 beam supported")
    return np.clip(ring, 0, n_scans - 1), valid


def rel_time_from_azimuth(xyz: np.ndarray) -> np.ndarray:
    """Per-point sweep fraction from the horizontal angle — the reference's
    startOri/endOri bookkeeping (scanRegistration.cpp:115-207) vectorized.

    Real sweeps are not exactly one revolution: endOri comes from the LAST
    point (+2π, clamped into (π, 3π] of startOri), and each point's angle
    is unwrapped by the halfPassed two-branch state machine.  The machine
    flips exactly once — at the first point whose branch-1-corrected angle
    exceeds startOri + π — so it vectorizes into a trigger-index split
    (the trigger point itself still uses its branch-1 angle, matching the
    C++ flag update order).  relTime can leave [0, 1] by design
    (cpp comment: −0.5 < relTime < 1.5); deskew consumes it as-is.
    Verified against the exact sequential transliteration
    (the JAX package's utils/parity.reference_rel_time,
    tests/test_parity_oracles.py)."""
    ori = -np.arctan2(xyz[:, 1], xyz[:, 0])
    start = float(ori[0])
    end = float(-np.arctan2(xyz[-1, 1], xyz[-1, 0])) + 2 * np.pi
    if end - start > 3 * np.pi:
        end -= 2 * np.pi
    elif end - start < np.pi:
        end += 2 * np.pi
    o1 = (
        ori
        + 2 * np.pi * (ori < start - np.pi / 2)
        - 2 * np.pi * (ori > start + 1.5 * np.pi)
    )
    passed = o1 - start > np.pi
    t = int(np.argmax(passed)) if passed.any() else len(ori)
    o2 = ori + 2 * np.pi
    o2 = (
        o2
        + 2 * np.pi * (o2 < end - 1.5 * np.pi)
        - 2 * np.pi * (o2 > end + np.pi / 2)
    )
    out = o1.copy()
    out[t + 1:] = o2[t + 1:]
    return ((out - start) / (end - start)).astype(np.float32)


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
