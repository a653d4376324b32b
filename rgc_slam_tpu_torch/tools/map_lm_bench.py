"""The mapping LM's linearisation (``ops/cuda/map_lm``) on seeded problems:
the problems its tests use (``tests/test_torch_map_lm.py`` on the CPU,
``tests/test_torch_map_lm_cuda.py`` on the card) and the card time of one
evaluation at the benchmark's capacities, beside the plain version's:

    python -m rgc_slam_tpu_torch.tools.map_lm_bench [--reps 200] [--out FILE]

``problem`` builds ``models/mapping.scan_to_map_solve``'s ``consts`` for one
outer iteration from numpy draws: the four query clouds in the sensor
frame, each point's line (edges) or plane (surfs) drawn around its world
position with an offset of ~8 cm, so that some blocks sit inside Huber's
0.1 and some beyond it, a share of the rows at weight 0 (failed
correspondences), and the IMU and ground constants near the poses.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import mapping as mp
from ..ops import factors as fac
from ..ops.cuda import map_lm
from . import common

CELL_SIZES = (512, 512, 2048, 2048)     # the benchmark's corner, last corner, surf, last surf


def _quat(ypr):
    """[w, x, y, z] of R = Rz(yaw) Ry(pitch) Rx(roll)."""
    y, p, r = (a / 2.0 for a in ypr)
    cy, sy, cp, sp, cr, sr = np.cos(y), np.sin(y), np.cos(p), np.sin(p), np.cos(r), np.sin(r)
    return np.array([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy])


def _rotate(q, v):
    w, u = q[0], q[1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw])


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _plane(rs, distance):
    n = np.array([0.0, 0.0, 1.0]) + rs.normal(0, 0.03, 3)
    n /= np.linalg.norm(n)
    v1 = np.cross(n, [0.0, 1.0, 0.0])
    v1 /= np.linalg.norm(v1)
    return n, v1, np.cross(n, v1), distance


def problem(sizes=CELL_SIZES, seed=0, w_imu=1.0, w_ground=1.0, imu_cov=0.4, zero_share=0.15,
            rep_scale=1.0, device="cpu", dtype=torch.float32):
    """``scan_to_map_solve``'s consts for one frozen association: clouds of
    ``sizes`` (corner, last corner, surf, last surf) points; ``rep_scale``
    scales the NULL-loss rows as on an sp rank."""
    rs = np.random.RandomState(seed)
    q = _quat([rs.uniform(-np.pi, np.pi), rs.normal(0, 0.03), rs.normal(0, 0.03)])
    ql = _mul(_quat([rs.normal(0, 0.05), rs.normal(0, 0.01), rs.normal(0, 0.01)]), q)
    t = rs.uniform(-20, 20, 3)
    tl = t - rs.uniform(0.5, 1.2, 3) * [1.0, 1.0, 0.02]

    def cloud(n, qq, tt, edge):
        pts = np.stack([rs.uniform(-20, 20, n), rs.uniform(-20, 20, n), rs.uniform(-2, 3, n)], 1)
        pw = _rotate(qq, pts) + tt + rs.normal(0, 0.08, (n, 3))
        w = rs.uniform(0.6, 1.4, n) * (rs.random_sample(n) >= zero_share)
        if edge:
            u = _unit(rs, n)
            return pts, mp.EdgeCorr(pa=pw + 0.1 * u, pb=pw - 0.1 * u, w=w)
        nrm = _unit(rs, n)
        return pts, mp.PlaneCorr(n=nrm, d=-(nrm * pw).sum(1), w=w)

    corner, ec = cloud(sizes[0], q, t, True)
    cornl, ecl = cloud(sizes[1], ql, tl, True)
    surf, pc = cloud(sizes[2], q, t, False)
    surfl, pcl = cloud(sizes[3], ql, tl, False)
    g_last, g_cur, g_last2 = (_plane(rs, d) for d in (1.6, 1.58, 1.62))

    def ypr(qq):            # yaw left 0: the residuals read pitch and roll
        return np.array([0.0, np.arcsin(2 * (qq[0] * qq[2] - qq[1] * qq[3])),
                         np.arctan2(2 * (qq[0] * qq[1] + qq[2] * qq[3]),
                                    1 - 2 * (qq[1] ** 2 + qq[2] ** 2))])

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    def gp(g):
        return fac.PlaneParams(*(f(x) for x in g))

    def corr(c):
        return type(c)(*(f(x) for x in c))

    return dict(
        corner=f(corner), cornl=f(cornl), surf=f(surf), surfl=f(surfl),
        delta_q_imu=f(_mul(_quat(rs.normal(0, 0.01, 3)), _mul(_conj(ql), q))),
        imu_cov=f(imu_cov), w_imu=f(w_imu), imu_ypr=f(ypr(q) + rs.normal(0, 0.01, 3)),
        imu_ypr_last=f(ypr(ql) + rs.normal(0, 0.01, 3)), rep_scale=f(rep_scale),
        g_last=gp(g_last), g_cur=gp(g_cur), g_last2=gp(g_last2),
        q_w_last2=f(_mul(_quat(rs.normal(0, 0.05, 3)), ql)), t_w_last2=f(tl - [0.8, 0.3, 0.01]),
        q_w_curr_f=f(_quat([rs.normal(0, 0.1), 0.0, 0.0])),
        q_w_curr_f2=f(_quat([rs.normal(0, 0.1), 0.0, 0.0])), w_ground=f(w_ground),
        q=f(q), t=f(t), ql=f(ql), tl=f(tl), ec=corr(ec), ecl=corr(ecl), pc=corr(pc),
        pcl=corr(pcl))


def tangent(seed, scale=0.01, device="cpu", dtype=torch.float32):
    """A tangent x [12] as after accepted LM steps (0 at ``scale`` 0)."""
    x = np.random.RandomState(seed + 1000).normal(0, scale, 12)
    return torch.as_tensor(x, dtype=dtype, device=device)


def functions(loss: str):
    """The autodiff route's (residual_fn, cost_fn), as scan_to_map_solve
    builds them."""

    def residuals(delta, c):
        return torch.cat([mp._lidar_residuals(delta, c, loss), mp._other_residuals(delta, c)])

    def cost(delta, c):
        return mp._map_cost(delta, c, loss)

    return residuals, cost


def off_the_l1_edge(consts, x, band=1e-4):
    """``consts`` with weight 0 on the lidar points whose block norm at
    ``x`` lies within ``band`` (relative) of Huber's 0.1, and their count.
    The l1 loss differentiates its weight, whose derivative jumps there, and
    a float32 block norm carries ~1e-5 relative error (lp - pa from ~20 m
    coordinates to ~0.1 m), so two float32 evaluations of such a point may
    take different sides; the comparisons of the ``l1`` linearisations are
    made on the points that are not."""
    c64 = to({k: (type(v)(*(f.cpu() for f in v)) if isinstance(v, tuple) else v.cpu())
              for k, v in consts.items()}, torch.float64)
    qc, tc, qlc, tlc = mp._unpack(x.detach().cpu().double(), c64)
    out, cleared = dict(consts), 0
    for pts, corr, q, t in (("corner", "ec", qc, tc), ("cornl", "ecl", qlc, tlc),
                            ("surf", "pc", qc, tc), ("surfl", "pcl", qlc, tlc)):
        if pts in ("corner", "cornl"):
            s = (mp._edge_r(q, t, c64[pts], c64[corr]) ** 2).sum(-1)
        else:
            s = mp._plane_r(q, t, c64[pts], c64[corr]) ** 2
        near = ((s.sqrt() - 0.1).abs() < band * 0.1).to(consts[corr].w.device)
        cleared += int(near.sum())
        out[corr] = consts[corr]._replace(w=torch.where(near, torch.zeros_like(consts[corr].w),
                                                        consts[corr].w))
    return out, cleared


def to(consts, dtype):
    """``consts`` with every float tensor cast to ``dtype``."""

    def cast(v):
        if isinstance(v, tuple):
            return type(v)(*(cast(x) for x in v))
        return v.to(dtype)

    return {k: cast(v) for k, v in consts.items()}


def _time_ms(fn, reps: int) -> float:
    """Device ms a call of ``fn``, as a captured step runs it: ``reps`` calls
    captured into one CUDA graph, the graph replayed five times between
    CUDA events (after one warm replay)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with map_lm.capture_counts(), torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def _rel(a, b) -> float:
    return float(torch.linalg.norm((a.double() - b.double()).reshape(-1))
                 / torch.linalg.norm(b.double().reshape(-1)).clamp(min=1e-300))


def measure(dev, sizes=CELL_SIZES, seed=0, reps=200) -> dict:
    """For each loss, on the card: device ms of one linearisation and one
    trial cost by the kernel and by the plain version at ``sizes``, and the
    kernel's relative (Frobenius) distance from the plain version's H, g
    and cost."""
    res = {}
    for loss in ("huber", "l1"):
        c = problem(sizes, seed, device=dev)
        x = tangent(seed, device=dev)
        kernel = map_lm.linearizer(c, loss)
        plain = map_lm.plain_linearizer(*functions(loss), c)
        got, want = kernel(x), plain(x)
        res[loss] = {
            "linearize_ms": _time_ms(lambda: kernel(x), reps),
            "cost_ms": _time_ms(lambda: kernel(x, derivatives=False), reps),
            "plain_linearize_ms": _time_ms(lambda: plain(x), max(reps // 20, 3)),
            "plain_cost_ms": _time_ms(lambda: plain(x, derivatives=False), max(reps // 20, 3)),
            "rel_H": _rel(got[0], want[0]), "rel_g": _rel(got[1], want[1]),
            "rel_cost": _rel(got[2], want[2])}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    dev = common.device("cuda")
    res = {"card": common.device_line(dev), "sizes": list(CELL_SIZES),
           **measure(dev, CELL_SIZES, args.seed, args.reps)}
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
