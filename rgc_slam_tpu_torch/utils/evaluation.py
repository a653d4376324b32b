"""Trajectory evaluation: evo-style ATE / RPE on TUM-format trajectories.

A copy of ``rgc_slam_tpu/utils/evaluation.py``, kept in the port so that it
imports nothing of the JAX package; ``tests/test_torch_synthetic.py`` holds
the two to the same numbers and bytes.

The reference dumps TUM trajectories for offline `evo` evaluation
(RGC_odometer.cpp:1315-1316, RGC_mapping.cpp:347-372); this module provides
the matching in-repo evaluator so tests and benches can assert accuracy
directly (SURVEY §4's "implication for the rebuild").
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid alignment est->gt.  Returns (R, t, s)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    C = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / (E * E).sum() * len(est)) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after (optional) SE(3) alignment."""
    est = np.asarray(est_xyz, float)
    gt = np.asarray(gt_xyz, float)
    if align:
        R, t, s = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    d = est - gt
    return float(np.sqrt((d * d).sum(axis=1).mean()))


def rpe_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, delta: int = 1) -> float:
    """Relative pose error (translation only) over a fixed frame delta."""
    est = np.asarray(est_xyz, float)
    gt = np.asarray(gt_xyz, float)
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(de, axis=1) - np.linalg.norm(dg, axis=1)
    return float(np.sqrt((err * err).mean()))


def dump_tum(path: str, stamps, xyz, quats_wxyz):
    """Write a TUM-format trajectory (timestamp x y z qx qy qz qw)."""
    with open(path, "w") as f:
        for s, p, q in zip(stamps, xyz, quats_wxyz):
            f.write(
                f"{s:.6f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
            )
