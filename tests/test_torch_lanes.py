"""utils/lanes.any_lane and the loops built on it, under ``torch.func.vmap``.

A loop or branch read on the host must keep ``jax.vmap``'s semantics: it
runs while any lane needs it, and a lane that is done keeps its carry.  So
every lane of a vmapped call must give what its own unbatched call gives:
``lm_drive`` the same outer iterations, accept/reject sequence and reject
counts exactly, λ and y0 to 1e-5 relative (a batched reduction may round
differently), the pose to 1e-5; ``factors._cg`` x to 1e-5 relative.  All
of it with the vmap fallback off (``strict_vmap``): an operator without a
batching rule raises.
"""
import numpy as np
import pytest
import torch
from torch.func import vmap

from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.ops import factors as tfac
from rgc_slam_tpu_torch.ops import registration as tr
from rgc_slam_tpu_torch.ops import voxelhash as tv
from rgc_slam_tpu_torch.utils import math3d as tm3
from rgc_slam_tpu_torch.utils.lanes import any_lane, strict_vmap

torch.set_num_threads(1)


def test_any_lane_unbatched():
    assert any_lane(torch.tensor(True)).item() and not any_lane(torch.tensor(False)).item()
    assert any_lane(torch.tensor([False, True, False])).item()
    out = any_lane(torch.zeros(4, dtype=torch.bool))
    assert out.shape == () and out.dtype == torch.bool and not out.item()


@pytest.mark.parametrize("lanes,expect", [([False, False, True], True), ([False] * 3, False)])
def test_any_lane_batched_is_read_on_the_host(lanes, expect):
    seen = []

    def f(p):
        seen.append(bool(any_lane(p)))          # a host read inside vmap
        return p.to(torch.int32)

    with strict_vmap():
        vmap(f)(torch.tensor(lanes))
    assert seen == [expect]


def test_any_lane_nested_vmap():
    """Two levels of lanes: the reduction covers both."""
    seen = []

    def f(p):
        seen.append(bool(any_lane(p > 5)))
        return p

    x = torch.arange(12).reshape(3, 4)
    with strict_vmap():
        vmap(vmap(f))(x)
        vmap(vmap(f))(x - 100)
    assert seen == [True, False]


def test_lane_loop_freezes_finished_lanes():
    """The loop pattern: runs until the last lane is done, each lane's count
    is its own, a finished lane's carry is kept."""

    def halve_until_small(x):
        n = torch.zeros((), dtype=torch.int32)
        active = x > 1.0
        while bool(any_lane(active)):
            x = torch.where(active, x / 2.0, x)
            n = n + active.to(torch.int32)
            active = x > 1.0
        return x, n

    xs = torch.tensor([0.5, 3.0, 40.0, 1000.0])
    with strict_vmap():
        xb, nb = vmap(halve_until_small)(xs)
    for i, x0 in enumerate(xs):
        x1, n1 = halve_until_small(x0)
        assert float(xb[i]) == float(x1) and int(nb[i]) == int(n1)
    assert nb.tolist() == [0, 2, 6, 10]


def _vgicp_problem(seed=0, n_src=768):
    """tests/test_torch_registration.py's scene: three textured planes."""
    g = np.random.default_rng(seed)
    n = 1500
    u, v = g.uniform(-8, 8, n), g.uniform(0, 3, n)
    floor = np.stack([g.uniform(-8, 8, n), g.uniform(-8, 8, n), 0.1 * np.sin(u)], 1)
    wall_x = np.stack([np.full(n, 6.0) + 0.1 * np.sin(2 * v), u, v], 1)
    wall_y = np.stack([u, np.full(n, -5.0) + 0.1 * np.cos(u), v], 1)
    pts = np.concatenate([floor, wall_x, wall_y]) + g.normal(0, 0.01, (3 * n, 3))
    normals = np.concatenate([np.tile([0, 0, 1.0], (n, 1)), np.tile([1.0, 0, 0], (n, 1)),
                              np.tile([0, 1.0, 0], (n, 1))])
    covs = np.eye(3)[None] - (1 - 1e-3) * normals[:, :, None] * normals[:, None, :]
    T = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dt)  # noqa: E731
    vm = tv.build_gaussian_voxelmap(T(pts), T(covs), torch.ones(len(pts), dtype=torch.bool), 1.0,
                                    TCFG.max_voxels)
    sel = g.choice(len(pts), n_src, replace=False)
    q_true = tm3.quat_exp(torch.tensor([0.01, -0.02, 0.03]))
    R = tm3.quat_to_mat(q_true).numpy().astype(np.float64)
    t_true = np.array([0.12, -0.08, 0.03])
    src = T((pts[sel] - t_true) @ R)
    src_cov = T(np.einsum("ji,njk,kl->nil", R, covs[sel], R))
    src_mask = torch.from_numpy(g.random(n_src) > 0.05)
    return src, src_cov, src_mask, vm


def test_lm_drive_lanes_equal_unbatched_runs():
    """Lanes started from different poses converge at different outer
    iterations; each lane equals its own unbatched run."""
    src, cov, mask, vm = _vgicp_problem()
    t0s = torch.tensor([[0.0, 0.0, 0.0], [0.11, -0.07, 0.03], [0.5, 0.4, -0.2]])
    q0s = torch.stack([tm3.quat_exp(torch.tensor(w)) for w in
                       ([0.0, 0.0, 0.0], [0.01, -0.02, 0.03], [0.05, 0.04, -0.08])])

    def run(q0, t0):
        res, trace = tr.lm_register(src, cov, mask, vm, q0, t0, TCFG, with_trace=True)
        return res.q, res.t, trace

    with strict_vmap():
        qb, tb, trb = vmap(run)(q0s, t0s)
    n_outer = []
    for b in range(len(t0s)):
        q1, t1, tr1 = run(q0s[b], t0s[b])
        n = int(tr1["n_outer"])
        n_outer.append(n)
        assert int(trb["n_outer"][b]) == n
        assert torch.equal(trb["accepted"][b], tr1["accepted"])
        assert torch.equal(trb["n_rejects"][b], tr1["n_rejects"])
        for key in ("lam_after", "y0"):
            a, e = trb[key][b, :n].double(), tr1[key][:n].double()
            assert float((a - e).abs().max()) <= 1e-5 * float(e.abs().max()), key
            assert bool(torch.isnan(trb[key][b, n:]).all())       # untouched padding
        torch.testing.assert_close(qb[b], q1, atol=1e-5, rtol=0)
        torch.testing.assert_close(tb[b], t1, atol=1e-5, rtol=0)
    assert len(set(n_outer)) > 1, n_outer        # the lanes did stop at different iterations


def test_cg_lanes_equal_unbatched_runs():
    """Systems of different conditioning stop at different CG steps."""
    g = np.random.default_rng(3)
    As, bs = [], []
    for scale in (0.5, 0.05, 0.005):
        M = g.normal(size=(24, 24))
        As.append(M @ M.T / 24 + scale * np.eye(24))
        bs.append(g.normal(size=24))
    A = torch.tensor(np.stack(As), dtype=torch.float32)
    b = torch.tensor(np.stack(bs), dtype=torch.float32)

    def solve(A1, b1):
        return tfac._cg(lambda v: A1 @ v, b1, 200)

    with strict_vmap():
        xb = vmap(solve)(A, b)
    for i in range(3):
        x1 = solve(A[i], b[i])
        assert float((xb[i] - x1).abs().max()) <= 1e-5 * float(x1.abs().max())
