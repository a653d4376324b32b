"""City streets for sweep logs: a grid of blocks and a staircase drive.

``street_grid`` fills the blocks of a square street grid with what a car's
LiDAR sees from the road: building boxes set back from the kerb with gaps
between them, parked cars (boxes) along the kerbs, poles and trees
(cylinders) on the pavement.  Every size and spacing is read from the
traffic file's ``world`` entry and drawn from the world seed; the grid
covers the drive's extent and ``margin_m`` around it.

``street_drive`` drives the street centre lines at a constant speed and
sensor height, turning at intersections in a staircase (left, right, left,
...) on quarter circles of ``turn_radius_m``, every ``leg_blocks`` blocks.
Its heading stays between east and north, so two poses whose travel differs
by ``d`` are at least ``d / sqrt(2)`` apart: the loop search, whose gates
want a travel difference over ``20 + r`` and a distance under ``r``, finds
no candidate while ``r < 20 / (sqrt(2) - 1)``, about 48 m.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def pitch(world: dict) -> float:
    """Centre line to centre line of two parallel streets (m)."""
    return world["block_m"] + world["street_m"]


def drive_segments(world: dict, tr: dict, length: float) -> List[Tuple]:
    """The drive's first ``length`` m or more as ("line", start [2],
    direction [2], length) and ("arc", centre [2], radius, start angle, turn
    sign, length) pieces.  It starts mid-block heading east on the street
    y = 0 and turns left at its first intersection."""
    P, R = pitch(world), tr["turn_radius_m"]
    leg = tr["leg_blocks"] * P
    if not 0 < R < P / 2 or tr["leg_blocks"] < 1:
        raise ValueError("streets: the turn radius has to lie under half a block's pitch, "
                         "and a leg has to span a block or more")
    segs: List[Tuple] = []
    pos, heading = np.array([P / 2, 0.0]), np.array([1.0, 0.0])
    corner = np.array([leg, 0.0])
    total, left = 0.0, True                     # east -> north, then north -> east
    while total < length:
        straight = float(np.abs(corner - pos).sum()) - R
        segs.append(("line", pos.copy(), heading.copy(), straight))
        arc_start = corner - R * heading
        normal = np.array([-heading[1], heading[0]]) * (1.0 if left else -1.0)
        centre = arc_start + R * normal
        phi0 = float(np.arctan2(*(arc_start - centre)[::-1]))
        segs.append(("arc", centre, R, phi0, 1.0 if left else -1.0, np.pi * R / 2))
        total += straight + np.pi * R / 2
        heading = np.array([0.0, 1.0]) if left else np.array([1.0, 0.0])
        pos = corner + R * heading
        corner = corner + leg * heading
        left = not left
    return segs


def street_drive(world: dict, tr: dict, n_poses: int):
    """[(R, t)] world poses at the scan times: ``tr["speed"]`` m/s, one pose
    every ``tr["dt"]`` s, the sensor at ``tr["height"]`` m."""
    step = tr["speed"] * tr["dt"]
    segs = drive_segments(world, tr, n_poses * step)
    ends = np.cumsum([s[-1] for s in segs])
    poses = []
    for k in range(n_poses):
        s = k * step
        j = int(np.searchsorted(ends, s, side="right"))
        u = s - (ends[j - 1] if j else 0.0)
        seg = segs[j]
        if seg[0] == "line":
            _, a, d, _ = seg
            xy, yaw = a + u * d, float(np.arctan2(d[1], d[0]))
        else:
            _, c, r, phi0, sign, _ = seg
            phi = phi0 + sign * u / r
            xy, yaw = c + r * np.array([np.cos(phi), np.sin(phi)]), phi + sign * np.pi / 2
        poses.append((_rot_z(yaw), np.array([xy[0], xy[1], tr["height"]])))
    return poses


def _u(rng, lo_hi) -> float:
    lo, hi = lo_hi
    return float(rng.uniform(lo, hi))


def _along(rng, start: float, end: float, size, gap) -> List[Tuple[float, float]]:
    """Intervals [a, b] along one kerb from ``start`` to ``end``: sizes and
    gaps drawn from their ranges, the first after a gap."""
    out, u = [], start + _u(rng, gap)
    while True:
        w = _u(rng, size)
        if u + w > end:
            return out
        out.append((u, u + w))
        u += w + _u(rng, gap)


def street_grid(world: dict, seed: int, lo: np.ndarray, hi: np.ndarray):
    """The blocks whose squares meet [lo - margin, hi + margin] (x, y),
    filled from ``world``'s ranges with ``seed``: (boxes [B, 6], their
    albedo [B], cylinders [C, 4], their albedo [C]), as ``raycast.World``
    holds them."""
    rng = np.random.default_rng(seed)
    P, s, L = pitch(world), world["street_m"], world["block_m"]
    b, car, pole, tree = world["building"], world["car"], world["pole"], world["tree"]
    m = world["margin_m"]
    boxes, cyls = [], []
    i0, i1 = int(np.floor((lo[0] - m) / P)), int(np.ceil((hi[0] + m) / P))
    j0, j1 = int(np.floor((lo[1] - m) / P)), int(np.ceil((hi[1] + m) / P))
    for i in range(i0, i1):
        for j in range(j0, j1):
            x0, y0 = i * P + s / 2, j * P + s / 2           # the block's kerbs
            x1, y1 = x0 + L, y0 + L
            # each side as (origin on the kerb, along, inward), walked along
            sides = [(np.array([x0, y0]), np.array([1.0, 0.0]), np.array([0.0, 1.0])),
                     (np.array([x1, y1]), np.array([-1.0, 0.0]), np.array([0.0, -1.0])),
                     (np.array([x0, y1]), np.array([0.0, -1.0]), np.array([1.0, 0.0])),
                     (np.array([x1, y0]), np.array([0.0, 1.0]), np.array([-1.0, 0.0]))]
            for o, a, n in sides:
                for u0, u1 in _along(rng, 0.0, L, b["frontage_m"], b["gap_m"]):
                    sb = _u(rng, b["setback_m"])
                    depth = min(_u(rng, b["depth_m"]), L / 2 - sb)
                    boxes.append(_box(o, a, n, u0, u1, sb, sb + depth, _u(rng, b["height_m"])))
                clear = car["corner_clear_m"]
                for u0, u1 in _along(rng, clear, L - clear, car["length_m"], car["gap_m"]):
                    w = _u(rng, car["width_m"])
                    g = car["kerb_gap_m"]
                    boxes.append(_box(o, a, n, u0, u1, -g - w, -g, _u(rng, car["height_m"])))
                for kind in (pole, tree):
                    for u0, u1 in _along(rng, 0.0, L, (0.0, 0.0), kind["spacing_m"]):
                        xy = o + u0 * a + kind["kerb_offset_m"] * n
                        cyls.append([xy[0], xy[1], _u(rng, kind["radius_m"]),
                                     _u(rng, kind["height_m"])])
    boxes_a = np.array(boxes).reshape(-1, 6)
    cyls_a = np.array(cyls).reshape(-1, 4)
    return (boxes_a, rng.uniform(*world["albedo"], len(boxes_a)), cyls_a,
            rng.uniform(*world["albedo"], len(cyls_a)))


def _box(o, a, n, u0, u1, v0, v1, h) -> List[float]:
    """The axis-aligned box over [u0, u1] along ``a`` and [v0, v1] along
    ``n`` from ``o``, ``h`` m high."""
    c = np.stack([o + u * a + v * n for u in (u0, u1) for v in (v0, v1)])
    return [*c.min(0), 0.0, *c.max(0), h]
