"""Map / trajectory exports: the port of ``rgc_slam_tpu/io/export.py``.

The reference's observability surface is rviz topics + file dumps:
  * A16 high-rate pose republisher (RGC_mapping.cpp:403-631) — compose every
    odometry pose with the current map->odom correction: ``compose_map_pose``.
  * A17 global map publisher (RGC_mapping.cpp:2468-2565) — uniform-sample
    keyframes, re-transform their clouds, voxel-downsample: ``global_map``.
  * A18 loop-constraint markers (RGC_mapping.cpp:687-732, 2227-2300) —
    exported as line-segment lists: ``loop_edges``.
  * per-keyframe PCD dumps (RGC_mapping.cpp:1933-1936) — ``write_pcd``.

The functions take the port's ``MappingState`` / ``LoopState`` on any
device and compute on the host (the keyframe store is copied to the CPU
once), as the JAX module does; on the same state they select the same
keyframes and points in the same order, and ``write_pcd`` writes the same
bytes (``tests/test_torch_io.py``).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..models.mapping import MappingState
from ..utils import math3d as m3


def compose_map_pose(q_md, t_md, q_odom, t_odom):
    """Map-frame pose for a raw odometry pose (A16's transform composition)."""
    q = m3.quat_normalize(m3.quat_mul(q_md, q_odom))
    t = t_md + m3.quat_rotate(q_md, t_odom)
    return q, t


def global_map(
    ms: MappingState,
    cfg: SlamConfig,
    sample_dist: float = 0.5,
    density: float = 0.2,
    cap: int = 1 << 18,
) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble the global map (A17): keyframes uniform-sampled by position
    (>= sample_dist apart), clouds re-transformed by their (loop-corrected)
    poses, voxel-downsampled at ``density``.  Host-side (export path)."""
    n_kf = int(ms.kf_count)
    if n_kf == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
    kf_t = ms.kf_t[:n_kf].cpu().numpy()
    # uniform sampling on keyframe positions (ref globalMapVisualizationPoseDensity)
    chosen = []
    for i in range(n_kf):
        if not chosen or np.linalg.norm(kf_t[i] - kf_t[chosen[-1]]) >= sample_dist:
            chosen.append(i)
    sel = torch.tensor(chosen, device=ms.kf_t.device)
    q = ms.kf_q[sel].cpu()[:, None, :]
    t = ms.kf_t[sel].cpu()[:, None, :]
    parts = []
    for cloud, confs, mask in ((ms.kf_corner, ms.kf_corner_conf, ms.kf_corner_mask),
                               (ms.kf_surf, ms.kf_surf_conf, ms.kf_surf_mask)):
        w = (m3.quat_rotate(q, cloud[sel].cpu()) + t).numpy()
        parts.append((w, confs[sel].cpu().numpy(), mask[sel].cpu().numpy()))
    pts_all, conf_all = [], []
    for j in range(len(chosen)):              # corner then surf, keyframe by keyframe
        for w, confs, msk in parts:
            pts_all.append(w[j][msk[j]])
            conf_all.append(confs[j][msk[j]])
    pts = np.concatenate(pts_all).astype(np.float32)
    conf = np.concatenate(conf_all).astype(np.float32)
    if len(pts) == 0:
        return pts, conf
    # final voxel downsample at export density: the first point of each cell
    origin = pts.mean(0)
    cells = np.floor((pts - origin) * (1.0 / density)).astype(np.int64)
    _, first = np.unique(cells, axis=0, return_index=True)
    first = np.sort(first)
    return pts[first][:cap], conf[first][:cap]


def write_keyframe_pcds(ms: MappingState, out_dir: str):
    """Per-keyframe corner/surf PCD dumps (ref RGC_mapping.cpp:1933-1936)."""
    os.makedirs(out_dir, exist_ok=True)
    n_kf = int(ms.kf_count)
    host = {name: getattr(ms, name)[:n_kf].cpu().numpy() for name in (
        "kf_corner", "kf_corner_conf", "kf_corner_mask", "kf_surf", "kf_surf_conf",
        "kf_surf_mask")}
    for i in range(n_kf):
        cm, sm = host["kf_corner_mask"][i], host["kf_surf_mask"][i]
        write_pcd(os.path.join(out_dir, f"corner_{i:06d}.pcd"), host["kf_corner"][i][cm],
                  host["kf_corner_conf"][i][cm])
        write_pcd(os.path.join(out_dir, f"surf_{i:06d}.pcd"), host["kf_surf"][i][sm],
                  host["kf_surf_conf"][i][sm])


def loop_edges(ms: MappingState, loop_state) -> np.ndarray:
    """Loop-constraint line segments [L, 2, 3] (A18's MarkerArray)."""
    li = loop_state.loop_i.cpu().numpy()
    lj = loop_state.loop_j.cpu().numpy()
    ok = (li >= 0) & (lj >= 0)
    kf_t = ms.kf_t.cpu().numpy()
    return np.stack([kf_t[li[ok]], kf_t[lj[ok]]], axis=1)


def write_pcd(path: str, xyz: np.ndarray, intensity: Optional[np.ndarray] = None):
    """Binary PCD v0.7 writer (the reference dumps per-keyframe PCDs via PCL)."""
    n = len(xyz)
    fields = "x y z" + (" intensity" if intensity is not None else "")
    count = 4 if intensity is not None else 3
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {' '.join(['4'] * count)}\n"
        f"TYPE {' '.join(['F'] * count)}\n"
        f"COUNT {' '.join(['1'] * count)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        "DATA binary\n"
    )
    data = xyz.astype("<f4")
    if intensity is not None:
        data = np.concatenate([data, intensity.astype("<f4")[:, None]], axis=1)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(data.tobytes())


def read_pcd(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Minimal binary/ascii PCD reader (x y z [intensity])."""
    with open(path, "rb") as f:
        header = {}
        n_fields = 3
        while True:
            line = f.readline().decode().strip()
            if line.startswith("FIELDS"):
                n_fields = len(line.split()) - 1
            for key in ("POINTS", "DATA"):
                if line.startswith(key):
                    header[key] = line.split(maxsplit=1)[1]
            if line.startswith("DATA"):
                break
        n = int(header["POINTS"])
        if header["DATA"] == "binary":
            arr = np.frombuffer(f.read(n * n_fields * 4), dtype="<f4").reshape(n, n_fields)
        else:
            arr = np.loadtxt(f, dtype=np.float32).reshape(n, n_fields)
    xyz = arr[:, :3]
    inten = arr[:, 3] if n_fields > 3 else None
    return xyz, inten
