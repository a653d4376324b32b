"""Synthetic LiDAR world simulator.

A copy of ``rgc_slam_tpu/io/synthetic.py``, kept in the port so that it
imports nothing of the JAX package; ``tests/test_torch_synthetic.py`` holds
the two to the same arrays.

The reference is validated by replaying 4 recorded rosbags (SURVEY §4) that are
not redistributable; this module provides the equivalent ground-truth-bearing
data source for unit/e2e tests and benchmarks: an analytic world (ground plane,
walls, pillars, boxes with per-object reflectivity), a smooth robot trajectory,
ray-cast 16/32/64-beam Velodyne sweeps, and synthesized IMU streams.

Pure numpy on the host (data generation is I/O-side, not part of the jitted
engine), mirroring the role of the reference's bag-replay front door.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

DEG = np.pi / 180.0


@dataclasses.dataclass
class World:
    """Axis-aligned boxes + vertical cylinders + ground plane at z=0."""

    boxes: np.ndarray        # [B, 6] (xmin, ymin, zmin, xmax, ymax, zmax)
    box_albedo: np.ndarray   # [B]
    cylinders: np.ndarray    # [C, 4] (cx, cy, radius, height)
    cyl_albedo: np.ndarray   # [C]
    ground_albedo: float = 20.0
    stripe_period: float = 0.0   # >0: paint walls with intensity stripes
    stripe_amp: float = 0.0
    # piecewise ground: z = 0 for x < ramp_x0, z = ramp_slope*(x-ramp_x0) after
    ramp_x0: float = 0.0
    ramp_slope: float = 0.0


def corridor_world(length: float = 60.0, width: float = 6.0,
                   stripe_period: float = 1.5, stripe_amp: float = 120.0,
                   pillar_spacing: float | None = None,
                   alcove_spacing: float | None = None) -> World:
    """A long featureless corridor: geometrically degenerate along its axis,
    with intensity stripes on the walls (BASELINE config 3 analog).

    ``pillar_spacing`` adds thin wall-hugging cylinders every that many
    meters (staggered between the two walls) — door-frame/radiator clutter.
    ``alcove_spacing`` adds shallow wall-mounted boxes (cabinets/doorway
    recesses) every that many meters, staggered: their faces PERPENDICULAR
    to the corridor axis are what actually constrains along-axis motion
    for a distribution-matcher.  A distant END WALL does not: beyond
    ~voxel/ring-spacing range (~28 m for a VLP-16 at 1 m voxels) a wall
    subtends less than one ring per voxel, the voxel covariance collapses
    to a horizontal LINE, and PLANE regularization leaves the along-axis
    direction free — VGICP slides; thin cylinders degenerate the same way
    (vertical lines).  Without clutter a long corridor is effectively
    unobservable along its axis (any scan matcher dead-reckons there, the
    reference included)."""
    wall_t = 0.3
    boxes = [
        [-length / 2, -width / 2 - wall_t, 0.0, length / 2, -width / 2, 3.0],
        [-length / 2, width / 2, 0.0, length / 2, width / 2 + wall_t, 3.0],
        [length / 2, -width / 2 - wall_t, 0.0, length / 2 + wall_t, width / 2 + wall_t, 3.0],
        [-length / 2 - wall_t, -width / 2 - wall_t, 0.0, -length / 2, width / 2 + wall_t, 3.0],
    ]
    box_albedo = [60.0, 60.0, 60.0, 60.0]
    if alcove_spacing:
        x = -length / 2 + alcove_spacing / 2
        side = 1.0
        while x < length / 2 - 2.0:
            y_wall = side * width / 2
            y_in = y_wall - side * 0.45          # juts 0.45 m into the corridor
            boxes.append([x - 0.6, min(y_wall, y_in), 0.0,
                          x + 0.6, max(y_wall, y_in), 2.2])
            box_albedo.append(150.0)
            side = -side
            x += alcove_spacing
    cylinders, cyl_albedo = [], []
    if pillar_spacing:
        x = -length / 2 + pillar_spacing / 2
        side = 1.0
        while x < length / 2 - 1.0:
            cylinders.append([x, side * (width / 2 - 0.45), 0.15, 2.2])
            cyl_albedo.append(185.0)
            side = -side
            x += pillar_spacing
    return World(
        boxes=np.asarray(boxes, np.float64),
        box_albedo=np.asarray(box_albedo, np.float64),
        cylinders=np.asarray(cylinders, np.float64).reshape(-1, 4),
        cyl_albedo=np.asarray(cyl_albedo, np.float64),
        stripe_period=stripe_period,
        stripe_amp=stripe_amp,
    )


def default_world(seed: int = 0, extent: float = 40.0, n_pillars: int = 14,
                  n_boxes: int = 10) -> World:
    """A walled courtyard with pillars and boxes — geometry rich enough for
    edge/planar/intensity features and unambiguous registration."""
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


# ---------------------------------------------------------------------------
# ray casting
# ---------------------------------------------------------------------------


def _ray_ground(origins, dirs, world=None):
    """Intersect rays with the ground.  Returns t (inf if none).

    Ground is z=0, optionally transitioning to a ramp plane
    z = slope*(x - x0) for x >= x0 (tests the ground-change machinery)."""
    dz = dirs[:, 2]
    t_flat = -origins[:, 2] / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
    hit_x = origins[:, 0] + t_flat * dirs[:, 0]
    slope = getattr(world, "ramp_slope", 0.0) if world is not None else 0.0
    x0 = getattr(world, "ramp_x0", 0.0) if world is not None else 0.0
    if slope == 0.0:
        return np.where((dz < -1e-6) & (t_flat > 0), t_flat, np.inf)
    ok_flat = (dz < -1e-6) & (t_flat > 0) & (hit_x < x0)
    t_flat = np.where(ok_flat, t_flat, np.inf)
    # ramp plane: n.(p - p0) = 0 with n = (-slope, 0, 1)/|..|, p0 = (x0,0,0)
    n = np.array([-slope, 0.0, 1.0])
    denom = dirs @ n
    t_ramp = -(origins @ n - x0 * n[0]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    hit_xr = origins[:, 0] + t_ramp * dirs[:, 0]
    ok_ramp = (denom < -1e-6) & (t_ramp > 0) & (hit_xr >= x0)
    t_ramp = np.where(ok_ramp, t_ramp, np.inf)
    return np.minimum(t_flat, t_ramp)


def _ray_boxes(origins, dirs, boxes):
    """Slab-method ray/AABB.  Returns per-ray (t, box_index)."""
    n = origins.shape[0]
    t_best = np.full(n, np.inf)
    idx_best = np.full(n, -1, np.int32)
    inv = 1.0 / np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
    for b in range(boxes.shape[0]):
        lo, hi = boxes[b, :3], boxes[b, 3:]
        t1 = (lo[None, :] - origins) * inv
        t2 = (hi[None, :] - origins) * inv
        tmin = np.max(np.minimum(t1, t2), axis=1)
        tmax = np.min(np.maximum(t1, t2), axis=1)
        hit = (tmax >= tmin) & (tmax > 0)
        t = np.where(tmin > 0, tmin, tmax)
        better = hit & (t < t_best) & (t > 1e-3)
        t_best = np.where(better, t, t_best)
        idx_best = np.where(better, b, idx_best)
    return t_best, idx_best


def _ray_cylinders(origins, dirs, cyls):
    n = origins.shape[0]
    t_best = np.full(n, np.inf)
    idx_best = np.full(n, -1, np.int32)
    for c in range(cyls.shape[0]):
        cx, cy, r, h = cyls[c]
        ox = origins[:, 0] - cx
        oy = origins[:, 1] - cy
        dx, dy = dirs[:, 0], dirs[:, 1]
        a = dx * dx + dy * dy
        b = 2 * (ox * dx + oy * dy)
        cc = ox * ox + oy * oy - r * r
        disc = b * b - 4 * a * cc
        ok = (disc > 0) & (a > 1e-12)
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = (-b - sq) / np.where(ok, 2 * a, 1.0)
        z = origins[:, 2] + t * dirs[:, 2]
        hit = ok & (t > 1e-3) & (z >= 0) & (z <= h)
        better = hit & (t < t_best)
        t_best = np.where(better, t, t_best)
        idx_best = np.where(better, c, idx_best)
    return t_best, idx_best


def cast_scan(
    world: World,
    R: np.ndarray,
    t: np.ndarray,
    n_rings: int = 16,
    n_azimuth: int = 900,
    max_range: float = 80.0,
    noise: float = 0.01,
    rng: Optional[np.random.Generator] = None,
    per_point_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None,
):
    """Ray-cast one sweep from sensor pose (R, t) in world frame.

    Returns dict with sensor-frame xyz [N,3], intensity, ring, rel_time, mask,
    ordered ring-major (matching the reference's per-ring concatenation,
    scanRegistration.cpp:221-230).  ``per_point_pose`` optionally provides
    per-azimuth (R_i, t_i) arrays to simulate intra-scan motion distortion.
    """
    rng = rng or np.random.default_rng(0)
    if n_rings == 16:
        elev = (-15.0 + 2.0 * np.arange(16)) * DEG
    elif n_rings == 32:
        elev = np.linspace(-30.67, 10.67, 32) * DEG
    else:
        elev = np.linspace(-24.33, 2.0, 64) * DEG

    az = -2 * np.pi * np.arange(n_azimuth) / n_azimuth  # clockwise like Velodyne
    rel_time = np.arange(n_azimuth) / n_azimuth  # fraction of scan period

    ring_ids = np.repeat(np.arange(n_rings), n_azimuth)
    az_all = np.tile(az, n_rings)
    el_all = np.repeat(elev, n_azimuth)
    rt_all = np.tile(rel_time, n_rings)

    d_sensor = np.stack(
        [
            np.cos(el_all) * np.cos(az_all),
            np.cos(el_all) * np.sin(az_all),
            np.sin(el_all),
        ],
        axis=1,
    )
    if per_point_pose is not None:
        Rs, ts = per_point_pose  # [n_azimuth, 3, 3], [n_azimuth, 3]
        az_idx = np.tile(np.arange(n_azimuth), n_rings)
        Rw = Rs[az_idx]
        origins = ts[az_idx]
        d_world = np.einsum("nij,nj->ni", Rw, d_sensor)
    else:
        origins = np.broadcast_to(t, d_sensor.shape).copy()
        d_world = d_sensor @ R.T

    tg = _ray_ground(origins, d_world, world)
    tb, bi = _ray_boxes(origins, d_world, world.boxes)
    tc, ci = _ray_cylinders(origins, d_world, world.cylinders)

    t_hit = np.minimum(np.minimum(tg, tb), tc)
    which = np.where(
        t_hit == tg, 0, np.where(t_hit == tb, 1, 2)
    )
    valid = np.isfinite(t_hit) & (t_hit < max_range) & (t_hit > 0.3)

    t_noisy = t_hit + rng.normal(0, noise, t_hit.shape)
    pts_world = origins + d_world * np.where(valid, t_noisy, 1.0)[:, None]
    if per_point_pose is not None:
        # report each point in its instantaneous sensor frame (raw Velodyne
        # behavior — deskewing is the pipeline's job)
        pts_sensor = np.einsum("nj,nji->ni", pts_world - origins, Rw)
    else:
        pts_sensor = (pts_world - t) @ R

    box_alb = (
        world.box_albedo[np.clip(bi, 0, None)]
        if len(world.box_albedo) else np.zeros_like(t_hit)
    )
    cyl_alb = (
        world.cyl_albedo[np.clip(ci, 0, None)]
        if len(world.cyl_albedo) else np.zeros_like(t_hit)
    )
    albedo = np.where(which == 0, world.ground_albedo,
                      np.where(which == 1, box_alb, cyl_alb))
    if world.stripe_period > 0:
        # procedural intensity stripes along world x+y on structures (gives
        # intensity edges on geometrically featureless walls — the degraded
        # scenes RGC-SLAM's intensity-corner path targets)
        u = pts_world[:, 0] + pts_world[:, 1]
        stripe = (np.floor(u / world.stripe_period) % 2) * world.stripe_amp
        albedo = np.where(which > 0, albedo + stripe, albedo)
    # calibrated reflectivity (real Velodynes range-compensate intensity;
    # a range falloff here couples feature-pick positions to robot motion
    # and biases edge associations) + sensor noise
    intensity = albedo + rng.normal(0, 1.0, albedo.shape)

    return {
        "xyz": pts_sensor.astype(np.float32),
        "intensity": np.clip(intensity, 0, 255).astype(np.float32),
        "ring": ring_ids.astype(np.int32),
        "rel_time": rt_all.astype(np.float32),
        "mask": valid,
    }


# ---------------------------------------------------------------------------
# trajectory + IMU
# ---------------------------------------------------------------------------


def _rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def make_trajectory(
    n_scans: int,
    dt: float = 0.1,
    radius: float = 18.0,
    speed: float = 1.2,
    height: float = 0.56,
    closes_loop: bool = True,
    laps: float = 1.0,
):
    """Smooth loop trajectory (returns list of (R, t) world poses at scan times).

    The robot drives a rounded-square circuit; with ``closes_loop`` it returns
    near its start, exercising the loop-closure stack.
    """
    ts = np.arange(n_scans) * dt
    total = n_scans * dt
    omega = 2 * np.pi * laps / total if closes_loop else speed / radius
    poses = []
    for t in ts:
        a = omega * t
        # rounded-square via superellipse-ish parametrization
        x = radius * np.cos(a)
        y = radius * np.sin(a) * 0.8
        dx = -radius * omega * np.sin(a)
        dy = radius * omega * np.cos(a) * 0.8
        yaw = np.arctan2(dy, dx)
        poses.append((_rot_z(yaw), np.array([x, y, height])))
    return poses


def synthesize_imu(poses, dt, imu_rate=200.0, gravity=9.81, seed=3,
                   acc_noise=0.02, gyr_noise=0.002):
    """Generate IMU samples between consecutive scan poses.

    Angular velocity from finite-difference of rotations; specific force =
    R^T (a_world + g z).  Returns per-interval lists of (t, acc[3], gyr[3]).
    """
    rng = np.random.default_rng(seed)
    n = len(poses)
    m = int(round(imu_rate * dt))
    out = []
    for i in range(n):
        # centered finite differences; shift the stencil inward at boundaries
        # (a degenerate one-sided stencil would fabricate huge accelerations)
        c = min(max(i, 1), max(n - 2, 1)) if n >= 3 else 0
        R0, t0 = poses[max(c - 1, 0)]
        R1, t1 = poses[c]
        R2, t2 = poses[min(c + 1, n - 1)]
        # angular velocity (body) from R0->R2 over 2*dt
        dR = R0.T @ R2
        angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        if angle < 1e-9:
            w_body = np.zeros(3)
        else:
            axis = (
                np.array(
                    [dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]
                )
                / (2 * np.sin(angle))
            )
            w_body = axis * angle / (2 * dt)
        a_world = (t2 - 2 * t1 + t0) / (dt * dt)
        f_body = R1.T @ (a_world + np.array([0, 0, gravity]))
        samples_t = (i + np.arange(m) / m) * dt
        acc = f_body[None, :] + rng.normal(0, acc_noise, (m, 3))
        gyr = w_body[None, :] + rng.normal(0, gyr_noise, (m, 3))
        out.append((samples_t, acc.astype(np.float32), gyr.astype(np.float32)))
    return out


def clear_path(world: World, poses, margin: float = 2.0) -> World:
    """Remove obstacles within ``margin`` of the trajectory (the robot must
    not drive through geometry)."""
    path = np.stack([t for (_, t) in poses])[:, :2]

    def box_clear(b):
        cx = np.clip(path[:, 0], b[0], b[3])
        cy = np.clip(path[:, 1], b[1], b[4])
        d = np.hypot(path[:, 0] - cx, path[:, 1] - cy)
        return d.min() > margin

    def cyl_clear(c):
        d = np.hypot(path[:, 0] - c[0], path[:, 1] - c[1]) - c[2]
        return d.min() > margin

    bkeep = np.array([box_clear(b) for b in world.boxes])
    ckeep = np.array([cyl_clear(c) for c in world.cylinders])
    return World(
        boxes=world.boxes[bkeep],
        box_albedo=world.box_albedo[bkeep],
        cylinders=world.cylinders[ckeep],
        cyl_albedo=world.cyl_albedo[ckeep],
        ground_albedo=world.ground_albedo,
        stripe_period=world.stripe_period,
        stripe_amp=world.stripe_amp,
    )


def _slerp_R(R0, R1, f):
    """Rotation interpolation via axis-angle of the relative rotation."""
    dR = R0.T @ R1
    angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    if angle < 1e-10:
        return R0
    axis = np.array(
        [dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]
    ) / (2 * np.sin(angle))
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    a = angle * f
    return R0 @ (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K)


def generate_sequence(
    n_scans: int = 50,
    n_rings: int = 16,
    n_azimuth: int = 900,
    seed: int = 0,
    dt: float = 0.1,
    world: Optional[World] = None,
    closes_loop: bool = True,
    noise: float = 0.01,
    motion_distortion: bool = True,
    extent: float = 40.0,
    radius: float = 18.0,
    speed: float = 1.2,
    laps: float = 1.0,
):
    """Full synthetic dataset: scans (sensor frame), IMU, ground-truth poses.

    With ``motion_distortion``, sweep k is ray-cast with per-azimuth poses
    interpolated between trajectory poses k and k+1 (points reported in their
    instantaneous sensor frames, like a real spinning Velodyne); its ground
    truth pose is the END-of-sweep pose k+1 and its stamp (k+1)*dt — matching
    the reference's deskew-to-scan-end convention.  IMU window k covers the
    sweep interval.  Yields n_scans-1 usable scans.
    """
    poses = make_trajectory(n_scans, dt=dt, closes_loop=closes_loop, radius=radius, speed=speed, laps=laps)
    world = clear_path(world or default_world(seed, extent=extent), poses)
    imu = synthesize_imu(poses, dt)
    rng = np.random.default_rng(seed + 1)
    scans, gt_poses, stamps, imu_windows = [], [], [], []
    if motion_distortion:
        fr = np.arange(n_azimuth) / n_azimuth
        for k in range(n_scans - 1):
            R0, t0 = poses[k]
            R1, t1 = poses[k + 1]
            Rs = np.stack([_slerp_R(R0, R1, f) for f in fr])
            ts = t0[None, :] * (1 - fr[:, None]) + t1[None, :] * fr[:, None]
            scan = cast_scan(
                world, R1, t1, n_rings=n_rings, n_azimuth=n_azimuth, rng=rng,
                noise=noise, per_point_pose=(Rs, ts),
            )
            scans.append(scan)
            gt_poses.append((R1, t1))
            stamps.append((k + 1) * dt)
            imu_windows.append(imu[k])
    else:
        for k in range(n_scans):
            R, t = poses[k]
            scans.append(
                cast_scan(world, R, t, n_rings=n_rings, n_azimuth=n_azimuth,
                          rng=rng, noise=noise)
            )
            gt_poses.append((R, t))
            stamps.append(k * dt)
            imu_windows.append(imu[max(k - 1, 0)])
    return {
        "world": world,
        "poses": gt_poses,
        "imu": imu_windows,
        "scans": scans,
        "stamps": stamps,
        "dt": dt,
    }
