"""Synthetic sweep logs, made on the device from a seed.

A frozen copy of ``rgc_slam_tpu_torch/io/synthetic.py``'s world, trajectory
and IMU models (``default_world``, ``make_trajectory``, ``clear_path``,
``synthesize_imu``), with the ray casting rewritten in torch: every ray of a
batch of sweeps is cast at once, in float64, on the given device.  The
geometry is the copy's exactly (``slambench/tests`` holds the noiseless
sweeps and the noiseless IMU to the numpy original); the noise (range,
intensity, accelerometer, gyroscope) is drawn from one ``torch.Generator``
seeded from the run's seed, so a seed gives the same log on every run.

The sensor's ring table comes from its model (``ring_elevations_deg``); the
traffic file's ``world.kind`` and ``trajectory.kind`` choose between the
copy's courtyard and ellipse and the city streets of ``streets.py``.  A
traffic file without an ``imu`` entry gives a log without IMU windows.

Sweep ``k`` is cast with per-azimuth poses interpolated between trajectory
poses ``k`` and ``k + 1`` (motion distortion: each point in its instantaneous
sensor frame); its ground truth is pose ``k + 1``, its stamp ``(k + 1) dt``
and its IMU window the interval ``k``, as ``generate_sequence`` has them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import streets

DEG = np.pi / 180.0
MIN_RANGE = 0.3          # cast_scan's lower gate on a hit


@dataclasses.dataclass
class World:
    """Axis-aligned boxes + vertical cylinders + ground plane at z=0."""

    boxes: np.ndarray        # [B, 6] (xmin, ymin, zmin, xmax, ymax, zmax)
    box_albedo: np.ndarray   # [B]
    cylinders: np.ndarray    # [C, 4] (cx, cy, radius, height)
    cyl_albedo: np.ndarray   # [C]
    ground_albedo: float = 20.0


def default_world(seed: int = 0, extent: float = 40.0, n_pillars: int = 14,
                  n_boxes: int = 10) -> World:
    """A walled courtyard with pillars and boxes (the copy's)."""
    rng = np.random.default_rng(seed)
    e = extent
    wall_t = 0.4
    walls = np.array(
        [
            [-e, -e, 0.0, e, -e + wall_t, 4.0],
            [-e, e - wall_t, 0.0, e, e, 4.0],
            [-e, -e, 0.0, -e + wall_t, e, 4.0],
            [e - wall_t, -e, 0.0, e, e, 4.0],
        ]
    )
    boxes = []
    for _ in range(n_boxes):
        cx, cy = rng.uniform(-e * 0.7, e * 0.7, 2)
        if abs(cx) < 6 and abs(cy) < 6:
            cx += 8.0 * np.sign(cx if cx != 0 else 1.0)
        sx, sy = rng.uniform(0.8, 3.0, 2)
        h = rng.uniform(0.8, 3.0)
        boxes.append([cx - sx / 2, cy - sy / 2, 0.0, cx + sx / 2, cy + sy / 2, h])
    boxes = np.concatenate([walls, np.array(boxes)], axis=0)
    box_albedo = np.concatenate(
        [np.array([40.0, 120.0, 40.0, 120.0]), rng.uniform(30, 220, n_boxes)]
    )
    cyls = []
    for _ in range(n_pillars):
        cx, cy = rng.uniform(-e * 0.8, e * 0.8, 2)
        if abs(cx) < 5 and abs(cy) < 5:
            cy += 7.0
        cyls.append([cx, cy, rng.uniform(0.15, 0.5), rng.uniform(2.0, 4.0)])
    cylinders = np.array(cyls)
    cyl_albedo = rng.uniform(30, 230, n_pillars)
    return World(boxes, box_albedo, cylinders, cyl_albedo)


def _rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def make_trajectory(n_scans: int, dt: float = 0.1, radius: float = 18.0, speed: float = 1.2,
                    height: float = 0.56, closes_loop: bool = True, laps: float = 1.0):
    """The copy's ellipse: [(R, t)] world poses at the scan times."""
    ts = np.arange(n_scans) * dt
    total = n_scans * dt
    omega = 2 * np.pi * laps / total if closes_loop else speed / radius
    poses = []
    for t in ts:
        a = omega * t
        x = radius * np.cos(a)
        y = radius * np.sin(a) * 0.8
        dx = -radius * omega * np.sin(a)
        dy = radius * omega * np.cos(a) * 0.8
        yaw = np.arctan2(dy, dx)
        poses.append((_rot_z(yaw), np.array([x, y, height])))
    return poses


def clear_path(world: World, poses, margin: float = 2.0) -> World:
    """Remove obstacles within ``margin`` of the trajectory."""
    path = np.stack([t for (_, t) in poses])[:, :2]

    def box_clear(b):
        cx = np.clip(path[:, 0], b[0], b[3])
        cy = np.clip(path[:, 1], b[1], b[4])
        return np.hypot(path[:, 0] - cx, path[:, 1] - cy).min() > margin

    def cyl_clear(c):
        return (np.hypot(path[:, 0] - c[0], path[:, 1] - c[1]) - c[2]).min() > margin

    bkeep = np.array([box_clear(b) for b in world.boxes])
    ckeep = np.array([cyl_clear(c) for c in world.cylinders])
    return World(world.boxes[bkeep], world.box_albedo[bkeep], world.cylinders[ckeep],
                 world.cyl_albedo[ckeep], world.ground_albedo)


def imu_noiseless(poses, dt: float, imu_rate: float = 200.0, gravity: float = 9.81):
    """``synthesize_imu`` without its noise: per interval (t [m], f_body
    [3], w_body [3]) from centred finite differences of the poses."""
    n = len(poses)
    m = int(round(imu_rate * dt))
    out = []
    for i in range(n):
        c = min(max(i, 1), max(n - 2, 1)) if n >= 3 else 0
        R0, t0 = poses[max(c - 1, 0)]
        R1, t1 = poses[c]
        R2, t2 = poses[min(c + 1, n - 1)]
        dR = R0.T @ R2
        angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        if angle < 1e-9:
            w_body = np.zeros(3)
        else:
            axis = (np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
                    / (2 * np.sin(angle)))
            w_body = axis * angle / (2 * dt)
        a_world = (t2 - 2 * t1 + t0) / (dt * dt)
        f_body = R1.T @ (a_world + np.array([0, 0, gravity]))
        out.append(((i + np.arange(m) / m) * dt, f_body, w_body))
    return out


def _slerp_batch(R0: torch.Tensor, R1: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``_slerp_R`` of the copy for S pose pairs [S, 3, 3] at fractions f
    [A]: [S, A, 3, 3], the relative rotation's axis-angle scaled by f."""
    dR = R0.transpose(-1, -2) @ R1
    tr = dR.diagonal(dim1=-2, dim2=-1).sum(-1)
    angle = torch.arccos(torch.clamp((tr - 1) / 2, -1, 1))                    # [S]
    vee = torch.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0],
                       dR[:, 1, 0] - dR[:, 0, 1]], -1)
    small = angle < 1e-10
    axis = vee / torch.where(small, torch.ones_like(angle), 2 * torch.sin(angle))[:, None]
    z = torch.zeros_like(angle)
    K = torch.stack([torch.stack([z, -axis[:, 2], axis[:, 1]], -1),
                     torch.stack([axis[:, 2], z, -axis[:, 0]], -1),
                     torch.stack([-axis[:, 1], axis[:, 0], z], -1)], -2)         # [S, 3, 3]
    a = angle[:, None] * f[None, :]                                             # [S, A]
    eye = torch.eye(3, dtype=R0.dtype, device=R0.device)
    M = (eye + torch.sin(a)[..., None, None] * K[:, None]
         + (1 - torch.cos(a))[..., None, None] * (K @ K)[:, None])
    out = R0[:, None] @ M
    return torch.where(small[:, None, None, None], R0[:, None].expand_as(out), out)


def _first_hit(origins, dirs, world: World, dev):
    """(t_hit, albedo) of every ray [..., 3] against the world, as
    ``cast_scan``'s ground / box / cylinder tests and tie order have them."""
    f64 = torch.float64
    dz = dirs[..., 2]
    t_flat = -origins[..., 2] / torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
    tg = torch.where((dz < -1e-6) & (t_flat > 0), t_flat, torch.full_like(dz, torch.inf))

    inf = torch.full_like(dz, torch.inf)
    tb, bi = inf.clone(), torch.full(dz.shape, -1, dtype=torch.long, device=dev)
    boxes = torch.as_tensor(world.boxes, dtype=f64, device=dev)
    inv = 1.0 / torch.where(dirs.abs() < 1e-9, torch.full_like(dirs, 1e-9), dirs)
    for b in range(boxes.shape[0]):
        t1 = (boxes[b, :3] - origins) * inv
        t2 = (boxes[b, 3:] - origins) * inv
        tmin = torch.minimum(t1, t2).amax(-1)
        tmax = torch.maximum(t1, t2).amin(-1)
        hit = (tmax >= tmin) & (tmax > 0)
        t = torch.where(tmin > 0, tmin, tmax)
        better = hit & (t < tb) & (t > 1e-3)
        tb = torch.where(better, t, tb)
        bi = torch.where(better, torch.full_like(bi, b), bi)

    tc, ci = inf.clone(), torch.full(dz.shape, -1, dtype=torch.long, device=dev)
    for c in range(world.cylinders.shape[0]):
        cx, cy, r, h = (float(v) for v in world.cylinders[c])
        ox = origins[..., 0] - cx
        oy = origins[..., 1] - cy
        dx, dy = dirs[..., 0], dirs[..., 1]
        a = dx * dx + dy * dy
        bq = 2 * (ox * dx + oy * dy)
        cc = ox * ox + oy * oy - r * r
        disc = bq * bq - 4 * a * cc
        ok = (disc > 0) & (a > 1e-12)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t = (-bq - sq) / torch.where(ok, 2 * a, torch.ones_like(a))
        z = origins[..., 2] + t * dirs[..., 2]
        hit = ok & (t > 1e-3) & (z >= 0) & (z <= h)
        better = hit & (t < tc)
        tc = torch.where(better, t, tc)
        ci = torch.where(better, torch.full_like(ci, c), ci)

    t_hit = torch.minimum(torch.minimum(tg, tb), tc)
    box_alb = torch.as_tensor(world.box_albedo, dtype=f64, device=dev)
    cyl_alb = torch.as_tensor(world.cyl_albedo, dtype=f64, device=dev)
    alb_b = box_alb[bi.clamp(min=0)] if len(world.box_albedo) else torch.zeros_like(t_hit)
    alb_c = cyl_alb[ci.clamp(min=0)] if len(world.cyl_albedo) else torch.zeros_like(t_hit)
    albedo = torch.where(t_hit == tg, torch.full_like(t_hit, world.ground_albedo),
                         torch.where(t_hit == tb, alb_b, alb_c))
    return t_hit, albedo


def ring_elevations_deg(sensor: dict) -> np.ndarray:
    """The nominal elevation (degrees) of each ring of ``sensor["model"]``,
    in ring order: the VLP-16's -15 + 2 i (ring 0 the lowest); the
    HDL-64E's 2 - i / 3 for i < 32 and -8.83 - (i - 32) / 2 beyond (ring 0
    the highest), the elevations scanRegistration.cpp:163-178's 64-beam
    binning inverts.  ``sensor["rings"]`` has to be the table's length."""
    model = sensor["model"]
    if model == "VLP-16":
        elev = -15.0 + 2.0 * np.arange(16)
    elif model == "HDL-64E":
        i = np.arange(32)
        elev = np.concatenate([2.0 - i / 3.0, -8.83 - i / 2.0])
    else:
        raise ValueError(f"raycast: no ring table for the sensor model {model!r}")
    if sensor["rings"] != len(elev):
        raise ValueError(f"raycast: the {model} has {len(elev)} rings, the sensor states "
                         f"{sensor['rings']}")
    return elev


def cast_sweeps(world: World, poses, first: int, count: int, sensor: dict, noise: float,
                generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Sweeps ``first .. first + count - 1`` of the log, motion-distorted,
    each ``rings x azimuth`` rays of ``sensor`` ring-major: xyz [S, R, 3]
    float32 in each point's sensor frame, intensity, ring, rel_time, mask
    [S, R].  ``noise`` (m) on each range and N(0, 1) on each intensity come
    from ``generator``; 0 and ``generator=None`` cast noiseless sweeps."""
    f64 = torch.float64
    dev = torch.device(device)
    elev_deg = ring_elevations_deg(sensor)
    n_rings, n_azimuth, max_range = len(elev_deg), sensor["azimuth"], sensor["max_range_m"]
    elev = torch.as_tensor(elev_deg * DEG, dtype=f64, device=dev)
    ar = torch.arange(n_azimuth, dtype=f64, device=dev)
    az = -2 * np.pi * ar / n_azimuth
    frac = ar / n_azimuth
    el_all = elev.repeat_interleave(n_azimuth)
    az_all = az.repeat(n_rings)
    d_sensor = torch.stack([torch.cos(el_all) * torch.cos(az_all),
                            torch.cos(el_all) * torch.sin(az_all), torch.sin(el_all)], -1)

    R = torch.as_tensor(np.stack([p[0] for p in poses[first:first + count + 1]]), dtype=f64,
                        device=dev)
    T = torch.as_tensor(np.stack([p[1] for p in poses[first:first + count + 1]]), dtype=f64,
                        device=dev)
    Rs = _slerp_batch(R[:-1], R[1:], frac)                                     # [S, A, 3, 3]
    ts = T[:-1, None, :] * (1 - frac[None, :, None]) + T[1:, None, :] * frac[None, :, None]
    Rw = Rs.repeat(1, n_rings, 1, 1)                                            # [S, R, 3, 3]
    origins = ts.repeat(1, n_rings, 1)                                          # [S, R, 3]
    d_world = (Rw @ d_sensor[None, :, :, None])[..., 0]

    t_hit, albedo = _first_hit(origins, d_world, world, dev)
    valid = torch.isfinite(t_hit) & (t_hit < max_range) & (t_hit > MIN_RANGE)
    if noise > 0:
        t_noisy = t_hit + noise * torch.randn(t_hit.shape, generator=generator, dtype=f64,
                                              device=dev)
        albedo = albedo + torch.randn(t_hit.shape, generator=generator, dtype=f64, device=dev)
    else:
        t_noisy = t_hit
    rng_used = torch.where(valid, t_noisy, torch.ones_like(t_noisy))
    pts_world = origins + d_world * rng_used[..., None]
    pts_sensor = ((pts_world - origins)[..., None, :] @ Rw)[..., 0, :]
    S = count
    return {
        "xyz": pts_sensor.to(torch.float32),
        "intensity": albedo.clamp(0, 255).to(torch.float32),
        "ring": torch.arange(n_rings, dtype=torch.int32, device=dev)
        .repeat_interleave(n_azimuth).expand(S, -1).contiguous(),
        "rel_time": frac.repeat(n_rings).to(torch.float32).expand(S, -1).contiguous(),
        "mask": valid,
    }


def world_and_path(traffic: dict, world_seed: int, n_scans: int):
    """The log's world (obstacles on the path cleared) and its n_scans + 1
    trajectory poses (sweep k spans poses k and k + 1): the copy's
    courtyard (``world.kind`` "default_world") and ellipse (no
    ``trajectory.kind``), or ``streets.py``'s "street_grid" and
    "street_drive"."""
    w, tr = traffic["world"], traffic["trajectory"]
    kind = tr.get("kind", "ellipse")
    if kind == "ellipse":
        poses = make_trajectory(n_scans + 1, dt=tr["dt"], radius=tr["radius"], speed=tr["speed"],
                                height=tr["height"], closes_loop=tr["closes_loop"],
                                laps=tr["laps"])
    elif kind == "street_drive":
        poses = streets.street_drive(w, tr, n_scans + 1)
    else:
        raise ValueError(f"raycast: unknown trajectory kind {kind!r}")
    if w["kind"] == "default_world":
        world = default_world(world_seed, extent=w["extent"])
    elif w["kind"] == "street_grid":
        path = np.stack([t for _, t in poses])[:, :2]
        world = World(*streets.street_grid(w, world_seed, path.min(0), path.max(0)))
    else:
        raise ValueError(f"raycast: unknown world kind {w['kind']!r}")
    return clear_path(world, poses), poses


def within(world: World, poses, reach: float) -> World:
    """The primitives of ``world``, in their order, that lie within
    ``reach`` m plus the longest step between two consecutive ``poses`` of
    one of them (in the plane): a ray cast from between two consecutive
    poses hits no other primitive closer than ``reach``."""
    xy = np.stack([t for _, t in poses])[:, :2]
    reach = reach + float(np.hypot(*np.diff(xy, axis=0).T).max(initial=0.0))
    b, c = world.boxes[:, None, :], world.cylinders[:, None, :]
    gap_b = np.hypot(xy[:, 0] - np.clip(xy[:, 0], b[..., 0], b[..., 3]),
                     xy[:, 1] - np.clip(xy[:, 1], b[..., 1], b[..., 4]))
    gap_c = np.hypot(xy[:, 0] - c[..., 0], xy[:, 1] - c[..., 1]) - c[..., 2]
    bkeep = gap_b.min(1, initial=np.inf) <= reach
    ckeep = gap_c.min(1, initial=np.inf) <= reach
    return World(world.boxes[bkeep], world.box_albedo[bkeep], world.cylinders[ckeep],
                 world.cyl_albedo[ckeep], world.ground_albedo)


def make_log(traffic: dict, sensor: dict, world_seed: int, n_scans: int,
             generator: torch.Generator, device, batch: int = 16):
    """``n_scans`` sweeps of one world on ``device`` and their IMU windows
    on the host: {"scans": {key: [n_scans, R, ...] tensor}, "imu": [(t,
    acc, gyr)] float32 numpy per scan, or None where the traffic file has no
    ``imu`` entry, "stamps": [n_scans] float, "poses": ground truth [(R,
    t)]}.  On a "street_grid" each batch of sweeps is cast against the
    primitives within the sensor's range of its poses only."""
    if not traffic["motion_distortion"]:
        raise ValueError("raycast: sweeps are cast with motion distortion only")
    world, poses = world_and_path(traffic, world_seed, n_scans)
    parts: List[Dict[str, torch.Tensor]] = []
    for first in range(0, n_scans, batch):
        count = min(batch, n_scans - first)
        seen = world
        if traffic["world"]["kind"] == "street_grid":
            seen = within(world, poses[first:first + count + 1], sensor["max_range_m"])
        parts.append(cast_sweeps(seen, poses, first, count, sensor, traffic["range_noise_m"],
                                 generator, device))
    scans = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    dt = traffic["trajectory"]["dt"]
    stamps = [(k + 1) * dt for k in range(n_scans)]
    log = {"scans": scans, "imu": None, "stamps": stamps, "poses": poses[1:n_scans + 1],
           "world": world}
    if "imu" not in traffic:
        return log
    imu_cfg = traffic["imu"]
    clean = imu_noiseless(poses, dt, imu_rate=imu_cfg["rate_hz"], gravity=imu_cfg["gravity"])
    m = len(clean[0][0])
    draws = torch.randn((n_scans, 2, m, 3), generator=generator, dtype=torch.float64,
                        device=device).cpu().numpy()
    imu = []
    for k in range(n_scans):
        t, f_body, w_body = clean[k]
        acc = f_body[None, :] + imu_cfg["acc_noise"] * draws[k, 0]
        gyr = w_body[None, :] + imu_cfg["gyr_noise"] * draws[k, 1]
        imu.append((t, acc.astype(np.float32), gyr.astype(np.float32)))
    log["imu"] = imu
    return log


def velodyne_sweep(scans: Dict[str, np.ndarray], k: int) -> np.ndarray:
    """Sweep ``k`` of a log's host arrays in KITTI's velodyne format:
    float32 [N, 4] of x, y, z and reflectance in [0, 1], the returns only,
    ring-major and in firing order within a ring, no ring and no time."""
    m = scans["mask"][k]
    return np.concatenate([scans["xyz"][k][m], scans["intensity"][k][m, None] / 255.0],
                          1).astype(np.float32)


def world_seeds(seed: int, count: int) -> Sequence[int]:
    """``count`` world seeds drawn from the run's seed."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(count, dtype=np.uint32)]
