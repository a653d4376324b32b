"""models/loop of the port (with ``factors.fourdof_residual``,
``factors.gauss_newton_cg`` and the loop-state bridge) against the JAX
package on the same numpy inputs.

Gates:
  * ``fourdof_residual``: |port - JAX| <= 1e-6 x max(1, |r|) (float32
    rounding of residuals up to ~20 m);
  * ``gauss_newton_cg`` and the CG alone: 1e-5 relative;
  * ``choose_loop_slot``, ``_maybe_compact``: every index and mask exact;
  * ``icp_point2point`` on the loop-ICP oracle's three cases: accept/reject
    equal to JAX and to ``utils/parity.reference_loop_icp``; R and t to 1e-4,
    fitness to 1e-3 relative and the match count exact on accepted cases;
  * ``_pgo_solve``: keyframe positions to 1e-4 m and yaw to 1e-5 rad against
    JAX, and the PGO oracle's gates (5e-3 m, 5e-4 rad) against
    ``reference_pgo_solve``;
  * ``loop_closure_step`` from a keyframe store built here (a drifted
    circle through one synthetic scene, the latest keyframe revisiting an
    early one): the flags, the candidate and the loop store's indices
    exactly, its float fields and the post-PGO poses to 1e-4, fitness to
    1e-3 relative; with no candidate, every method returns what JAX does;
  * ``SlamSystem`` with loops on across one cadence boundary, from a
    bridged JAX state: as above, with the one-step pose gate of
    tests/test_torch_slam.py (max(1e-4, 2 x the reference's own deviation
    under 1e-7 relative perturbations of the scan)).
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud, imu_from_interval as j_imu
from rgc_slam_tpu.models import loop as jloop
from rgc_slam_tpu.models import slam as jslam
from rgc_slam_tpu.ops import factors as jfac
from rgc_slam_tpu.utils import math3d as jm3
from rgc_slam_tpu.utils import parity
from rgc_slam_tpu_torch import bridge
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud, imu_from_interval as t_imu
from rgc_slam_tpu_torch.models import loop as tloop
from rgc_slam_tpu_torch.models import mapping as tmap
from rgc_slam_tpu_torch.models import slam as tslam
from rgc_slam_tpu_torch.ops import factors as tfac
from rgc_slam_tpu_torch.utils import math3d as tm3
from test_parity_oracles import _drifted, _loop_graph, _submap_points

torch.set_num_threads(1)
LOOP_INT_FIELDS = ("loop_i", "loop_j", "loop_stamp", "loop_count", "low_drift", "continue_count",
                   "last_kf_count")
LOOP_FLOAT_FIELDS = ("loop_t", "loop_yaw", "loop_pitch_j", "loop_roll_j", "last_loop_travel",
                     "distance_by_loop")


def _sd(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in leaves}


def _cfgs(**kw):
    return dataclasses.replace(JCFG, **kw), dataclasses.replace(TCFG, **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_loop_states(t_ls, j_ls, atol=1e-4):
    t, j = bridge.loop_state_to_numpy(t_ls), _sd(j_ls)
    for f in LOOP_INT_FIELDS:
        np.testing.assert_array_equal(t[f], j[f], err_msg=f)
    for f in LOOP_FLOAT_FIELDS:
        np.testing.assert_allclose(t[f], j[f], atol=atol, rtol=0, err_msg=f)


# ---------------------------------------------------------------------------
# factors: the FourDOF residual and the matrix-free Gauss-Newton
# ---------------------------------------------------------------------------


def test_fourdof_residual_matches():
    g = np.random.default_rng(0)
    L = 64
    yaw_i, yaw_j, yaw_m = g.uniform(-np.pi, np.pi, (3, L)).astype(np.float32)
    pitch, roll = g.uniform(-0.3, 0.3, (2, L)).astype(np.float32)
    t_i, t_j = g.uniform(-10, 10, (2, L, 3)).astype(np.float32)
    t_m = g.uniform(-2, 2, (L, 3)).astype(np.float32)
    args = [yaw_i, t_i, yaw_j, t_j, t_m, yaw_m, pitch, roll]
    j = np.asarray(jax.vmap(jfac.fourdof_residual)(*map(jnp.asarray, args)))
    t = tfac.fourdof_residual(*map(_t, args)).numpy()
    assert t.shape == (L, 4)
    assert (np.abs(t - j) <= 1e-6 * np.maximum(1.0, np.abs(j))).all(), np.abs(t - j).max()
    one = tfac.fourdof_residual(*[_t(a[3]) for a in args]).numpy()     # unbatched
    assert (np.abs(one - j[3]) <= 1e-6 * np.maximum(1.0, np.abs(j[3]))).all()


def _nls_problem(seed):
    """A small nonlinear least-squares problem: 40 residuals in 6 unknowns."""
    g = np.random.default_rng(seed)
    A = g.normal(size=(40, 6)).astype(np.float32)
    B = g.normal(size=(40, 6)).astype(np.float32) * 0.5
    x_true = g.normal(size=6).astype(np.float32)
    y = (A @ x_true + np.sin(B @ x_true)).astype(np.float32)
    return A, B, y


@pytest.mark.parametrize("seed,gn_iters,cg_iters", [(0, 6, 20), (1, 4, 3)])
def test_gauss_newton_cg_matches(seed, gn_iters, cg_iters):
    """Converged and truncated CG (3 steps of 6 dims) alike, to 1e-5."""
    A, B, y = _nls_problem(seed)

    def j_res(x):
        return A @ x + jnp.sin(B @ x) - y

    def t_res(x, c):
        return c["A"] @ x + torch.sin(c["B"] @ x) - c["y"]

    x0 = np.zeros(6, np.float32)
    xj = np.asarray(jax.jit(functools.partial(
        jfac.gauss_newton_cg, j_res, gn_iters=gn_iters, cg_iters=cg_iters))(jnp.asarray(x0)))
    xt = tfac.gauss_newton_cg(t_res, _t(x0), gn_iters=gn_iters, cg_iters=cg_iters,
                              consts=dict(A=_t(A), B=_t(B), y=_t(y))).numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-5 * np.abs(xj).max())


@pytest.mark.parametrize("maxiter", [4, 200])
def test_cg_follows_jax_cg(maxiter):
    g = np.random.default_rng(3)
    M = g.normal(size=(48, 48)).astype(np.float32)
    A = (M @ M.T / 48 + 0.05 * np.eye(48)).astype(np.float32)
    b = g.normal(size=48).astype(np.float32)
    xj, _ = jax.scipy.sparse.linalg.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                                       maxiter=maxiter)
    xt = tfac._cg(lambda v: _t(A) @ v, _t(b), maxiter).numpy()
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-5, atol=1e-5 * np.abs(xt).max())


# ---------------------------------------------------------------------------
# the loop store
# ---------------------------------------------------------------------------


def _slot_stores():
    """tests/test_loop.py's stores, seeded random ones, and a full store
    whose stamps are all 0 (argmin ties)."""
    L = 4
    stores = [
        dict(loop_i=[-1] * L, loop_j=[-1] * L, loop_stamp=[0] * L),
        dict(loop_i=[30, 40, -1, -1], loop_j=[5, 12, -1, -1], loop_stamp=[1, 2, 0, 0]),
        dict(loop_i=[30, 40, 50, 60], loop_j=[5, 12, 20, 33], loop_stamp=[1, 2, 3, 4]),
        dict(loop_i=[30, 40, 50, 60], loop_j=[15, 12, 3, 33], loop_stamp=[1, 2, 3, 4]),
        dict(loop_i=[30, 40, 50, -1], loop_j=[15, 12, 3, 33], loop_stamp=[1, 2, 3, 4]),
        dict(loop_i=[30, 40, 50, 60], loop_j=[7, 7, 9, 8], loop_stamp=[0, 0, 0, 0]),
    ]
    g = np.random.default_rng(7)
    for _ in range(40):
        used = g.random(L) < 0.8
        stores.append(dict(loop_i=np.where(used, g.integers(0, 60, L), -1),
                           loop_j=np.where(used, g.integers(0, 20, L), -1),
                           loop_stamp=g.integers(0, 6, L)))
    return stores


def test_choose_loop_slot_matches():
    jcfg, tcfg = _cfgs(max_loops=4)
    for store in _slot_stores():
        arrays = _sd(jloop.LoopState.init(jcfg))
        arrays.update({k: np.asarray(v, np.int32) for k, v in store.items()})
        j = jloop.choose_loop_slot(jloop.LoopState(**{k: jnp.asarray(v) for k, v in arrays.items()}))
        t = tloop.choose_loop_slot(bridge.loop_state_from_numpy(arrays, tcfg, "cpu"))
        assert t.dtype == torch.int32 and int(t) == int(j), store


def test_loop_state_bridge_round_trip():
    jcfg, tcfg = _cfgs()
    arrays = _sd(jloop.LoopState.init(jcfg))
    t_init = bridge.loop_state_to_numpy(tloop.LoopState.init(tcfg, "cpu"))
    assert t_init.keys() == arrays.keys()
    for k, v in arrays.items():                  # the port's init is JAX's init
        assert t_init[k].dtype == v.dtype and np.array_equal(t_init[k], v), k
    arrays["loop_t"] = np.arange(tcfg.max_loops * 3, dtype=np.float32).reshape(-1, 3)
    back = bridge.loop_state_to_numpy(bridge.loop_state_from_numpy(arrays, tcfg, "cpu"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(ValueError, match="loop_i"):
        bridge.loop_state_from_numpy({**arrays, "loop_i": arrays["loop_i"].astype(np.int64)},
                                     tcfg, "cpu")
    with pytest.raises(KeyError):
        bridge.loop_state_from_numpy({k: v for k, v in arrays.items() if k != "low_drift"},
                                     tcfg, "cpu")


# ---------------------------------------------------------------------------
# ICP
# ---------------------------------------------------------------------------

ICP_CASES = [
    # (src drift yaw, t), tgt seed offset, expect accept: the loop-ICP oracle's cases
    ((0.03, [0.3, -0.2, 0.05]), 0, True),
    ((0.10, [0.8, 0.5, -0.1]), 0, True),
    ((0.02, [0.1, 0.1, 0.0]), 7, False),
]


@pytest.mark.parametrize("case", range(len(ICP_CASES)))
def test_icp_point2point_matches(case):
    (yaw, tr), tgt_seed, expect = ICP_CASES[case]
    tgt = _submap_points(21 + tgt_seed, 3072, drop_box=tgt_seed != 0).astype(np.float32)
    src = _drifted(_submap_points(21, 512), yaw, tr, seed=case).astype(np.float32)
    max_corr, gate = 14.0, 0.1
    jq, jt, jfit, jn = jax.jit(functools.partial(
        jloop.icp_point2point, max_corr=jnp.asarray(max_corr, jnp.float32),
        iterations=JCFG.loop_icp_iterations,
    ))(jnp.asarray(src), jnp.ones(len(src), bool), jnp.asarray(tgt), jnp.ones(len(tgt), bool))
    tq, tt, tfit, tn = tloop.icp_point2point(
        _t(src), torch.ones(len(src), dtype=torch.bool), _t(tgt),
        torch.ones(len(tgt), dtype=torch.bool), torch.tensor(max_corr), TCFG.loop_icp_iterations)
    oracle = parity.reference_loop_icp(src, tgt, max_corr)
    acc_t, acc_j, acc_o = float(tfit) < gate, float(jfit) < gate, oracle["fitness"] < gate
    assert acc_t == acc_j == acc_o == expect, (float(tfit), float(jfit), oracle["fitness"])
    assert tn.dtype == torch.int32
    if expect:
        R_t, R_j = tm3.quat_to_mat(tq).numpy(), np.asarray(jm3.quat_to_mat(jq))
        assert np.abs(R_t - R_j).max() < 1e-4
        assert np.abs(tt.numpy() - np.asarray(jt)).max() < 1e-4
        assert abs(float(tfit) - float(jfit)) <= 1e-3 * float(jfit)
        assert int(tn) == int(jn)


def test_icp_with_no_source_point_reports_nothing():
    """An all-False source mask: fitness 0 and no match, as in JAX."""
    tgt = _submap_points(21, 1024).astype(np.float32)
    src = _drifted(_submap_points(21, 256), 0.02, [0.1, 0.0, 0.0]).astype(np.float32)
    _, _, jfit, jn = jloop.icp_point2point(
        jnp.asarray(src), jnp.zeros(len(src), bool), jnp.asarray(tgt), jnp.ones(len(tgt), bool),
        jnp.asarray(14.0), 3)
    _, _, tfit, tn = tloop.icp_point2point(
        _t(src), torch.zeros(len(src), dtype=torch.bool), _t(tgt),
        torch.ones(len(tgt), dtype=torch.bool), 14.0, 3)
    assert float(tfit) == float(jfit) == 0.0 and int(tn) == int(jn) == 0


# ---------------------------------------------------------------------------
# the pose graph
# ---------------------------------------------------------------------------


def _drift_chain(K=40):
    """tests/test_loop.py::test_pgo_removes_drift's chain: a straight line
    with drift in y and yaw, one exact loop 39 -> 12."""
    gt_t = np.stack([np.arange(K) * 1.0, np.zeros(K), np.zeros(K)], axis=1)
    est_t = gt_t + np.stack([np.zeros(K), np.linspace(0, 2.0, K), np.zeros(K)], axis=1)
    ypr = np.stack([np.linspace(0, 0.1, K), np.zeros(K), np.zeros(K)], axis=1)
    i, j = K - 1, 12
    return ypr, est_t, [(i, j, gt_t[i] - gt_t[j], 0.0)]


def _pgo_inputs(ypr, t, loops, jcfg):
    """A JAX MappingState / LoopState holding the graph."""
    K = len(ypr)
    ms = jslam.SlamState.init(jcfg).mapping
    KF = jcfg.max_keyframes
    kf_q = np.tile([1.0, 0, 0, 0], (KF, 1)).astype(np.float32)
    kf_t = np.zeros((KF, 3), np.float32)
    kf_q[:K] = np.asarray(jax.vmap(jm3.ypr_to_quat)(jnp.asarray(ypr, jnp.float32)))
    kf_t[:K] = t
    ms = ms.replace(kf_q=jnp.asarray(kf_q), kf_t=jnp.asarray(kf_t),
                    kf_count=jnp.asarray(K, jnp.int32),
                    kf_travel=jnp.asarray(np.arange(KF, dtype=np.float32)))
    ls = jloop.LoopState.init(jcfg)
    for s, (ki, kj, t_rel, rel_yaw) in enumerate(loops):
        ls = ls.replace(
            loop_i=ls.loop_i.at[s].set(ki), loop_j=ls.loop_j.at[s].set(kj),
            loop_t=ls.loop_t.at[s].set(jnp.asarray(t_rel, jnp.float32)),
            loop_yaw=ls.loop_yaw.at[s].set(rel_yaw),
            loop_pitch_j=ls.loop_pitch_j.at[s].set(ypr[kj, 1]),
            loop_roll_j=ls.loop_roll_j.at[s].set(ypr[kj, 2]),
            loop_stamp=ls.loop_stamp.at[s].set(s + 1),
        )
    return ms, ls.replace(loop_count=jnp.asarray(len(loops), jnp.int32))


@pytest.mark.parametrize("graph", ["square course", "drift chain"])
def test_pgo_solve_matches(graph):
    ypr, t, loops = _loop_graph() if graph == "square course" else _drift_chain()
    jcfg, tcfg = _cfgs(max_keyframes=64, max_loops=4)
    K = len(ypr)
    jms, jls = _pgo_inputs(ypr, t, loops, jcfg)
    jout = jax.jit(functools.partial(jloop._pgo_solve, cfg=jcfg))(jms, jls)
    tms = bridge.tree_from_numpy(tmap.MappingState.init(tcfg, "cpu"), _sd(jms), "cpu")
    tout = tloop._pgo_solve(tms, bridge.loop_state_from_numpy(_sd(jls), tcfg, "cpu"), tcfg)

    t_j, t_t = np.asarray(jout.kf_t), tout.kf_t.numpy()
    yaw_j = np.asarray(jax.vmap(jm3.quat_to_ypr)(jout.kf_q))[:, 0]
    yaw_t = tm3.quat_to_ypr(tout.kf_q).numpy()[:, 0]
    assert np.abs(t_t - t_j).max() < 1e-4
    assert np.abs(np.angle(np.exp(1j * (yaw_t - yaw_j)))).max() < 1e-5
    for f in ("q_md", "t_md", "q_w_last", "t_w_last", "q_w_last2", "t_w_last2"):
        np.testing.assert_allclose(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                   atol=1e-4, err_msg=f)
    oracle = parity.reference_pgo_solve(ypr, t, loops)
    assert np.abs(t_t[:K] - t).max() > 0.05                     # the solve moved the graph
    assert np.abs(t_t[:K] - oracle["t"]).max() < 5e-3
    assert np.abs(np.angle(np.exp(1j * (yaw_t[:K] - oracle["yaw"])))).max() < 5e-4


# ---------------------------------------------------------------------------
# compaction of the keyframe store with loops anchored
# ---------------------------------------------------------------------------

COMPACT_CASES = {
    # kf_count, loop_i, loop_j, last_kf_count (K = 64, COMPACT_MARGIN = 16)
    "at the margin": (48, [40, 45, -1, 47], [3, 10, -1, 6], 45),
    "full, a loop on an old keyframe": (64, [60, 63, 50, -1], [1, 2, 22, -1], 64),
    # every old-half keyframe anchored: protection leaves nothing to evict,
    # the unprotected rule runs and the loops on evicted keyframes drop
    "every old keyframe anchored": (64, list(range(16, 32)), list(range(16)), 60),
    "below the margin": (47, [40, 45, -1, -1], [3, 10, -1, -1], 47),
}


@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_maybe_compact_matches(case):
    kf_count, li, lj, last = COMPACT_CASES[case]
    jcfg, tcfg = _cfgs(max_loops=len(li))
    K = jcfg.max_keyframes
    state = jslam.SlamState.init(jcfg)
    xs = np.zeros((K, 3), np.float32)
    xs[:, 0] = np.arange(K) * 0.5
    state = state.replace(mapping=state.mapping.replace(
        kf_t=jnp.asarray(xs), kf_count=jnp.asarray(kf_count, jnp.int32),
        kf_stamp=jnp.asarray(np.arange(K, dtype=np.float32)),
        kf_surf_mask=state.mapping.kf_surf_mask.at[:, 0].set(jnp.arange(K) % 3 == 0)))
    ls = jloop.LoopState.init(jcfg).replace(
        loop_i=jnp.asarray(li, jnp.int32), loop_j=jnp.asarray(lj, jnp.int32),
        last_kf_count=jnp.asarray(last, jnp.int32))
    js, jls = jloop._maybe_compact(state, ls, jcfg)
    ts, tls = tloop._maybe_compact(bridge.state_from_numpy(_sd(state), tcfg, "cpu"),
                                   bridge.loop_state_from_numpy(_sd(ls), tcfg, "cpu"), tcfg)
    t_np, j_np = bridge.state_to_numpy(ts), _sd(js)
    for k in ("mapping.kf_count", "mapping.kf_t", "mapping.kf_stamp", "mapping.kf_surf_mask"):
        np.testing.assert_array_equal(t_np[k], j_np[k], err_msg=k)
    _assert_loop_states(tls, jls, atol=0)
    if case == "below the margin":
        assert int(ts.mapping.kf_count) == kf_count
    else:
        assert int(ts.mapping.kf_count) < kf_count            # it compacted
    if case == "every old keyframe anchored":
        assert (tls.loop_i < 0).any() and (tls.loop_i >= 0).any()


# ---------------------------------------------------------------------------
# the loop-closure step from a keyframe store built here
# ---------------------------------------------------------------------------

CIRCLE_R, KF_SPACING, N_KF = 6.0, 1.0, 44


def _scene(seed=0):
    """One static scene around a circle of radius 6 m: an outer wall at
    10 m, pillars at scattered angles and radii (they break the wall's
    rotational symmetry) and a floor annulus 0.56 m below the sensor."""
    g = np.random.default_rng(seed)
    th = g.uniform(0, 2 * np.pi, 8000)
    wall = np.stack([10 * np.cos(th), 10 * np.sin(th), g.uniform(-0.5, 2.0, th.size)], 1)
    pillars = []
    for a, r in zip(g.uniform(0, 2 * np.pi, 14), g.uniform(2.5, 8.5, 14)):
        if abs(r - CIRCLE_R) < 1.0:              # keep the path clear
            r += 2.0
        phi = g.uniform(0, 2 * np.pi, 250)
        pillars.append(np.stack([r * np.cos(a) + 0.3 * np.cos(phi), r * np.sin(a) + 0.3 * np.sin(phi),
                                 g.uniform(-0.5, 2.0, phi.size)], 1))
    rr, ft = np.sqrt(g.uniform(3.0 ** 2, 9.5 ** 2, 6000)), g.uniform(0, 2 * np.pi, 6000)
    floor = np.stack([rr * np.cos(ft), rr * np.sin(ft), np.full(rr.size, -0.56)], 1)
    return np.concatenate(pillars), np.concatenate([wall, floor])


def _circle_store(jcfg, seed=0, n_kf=N_KF, yaw_drift=6e-4):
    """A JAX SlamState whose keyframe store holds ``n_kf`` keyframes 1 m
    apart on the circle, with poses drifting in yaw along the chain and
    clouds cut from one scene, so the latest revisits keyframe ~6."""
    corner_pts, surf_pts = _scene(seed)
    g = np.random.default_rng(seed + 1)
    ang = np.arange(n_kf) * KF_SPACING / CIRCLE_R
    gt_t = np.stack([CIRCLE_R * np.cos(ang), CIRCLE_R * np.sin(ang), np.zeros(n_kf)], 1)
    gt_yaw = ang + np.pi / 2
    drift = np.arange(n_kf) * yaw_drift
    est_t = gt_t.copy()
    for k in range(1, n_kf):
        c, s = np.cos(drift[k - 1]), np.sin(drift[k - 1])
        est_t[k] = est_t[k - 1] + np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]) @ (gt_t[k] - gt_t[k - 1])
    est_ypr = np.stack([gt_yaw + drift, np.zeros(n_kf), np.zeros(n_kf)], 1).astype(np.float32)

    K, C, S = jcfg.max_keyframes, jcfg.max_kf_corner, jcfg.max_kf_surf
    kf_corner, kf_surf = np.zeros((K, C, 3), np.float32), np.zeros((K, S, 3), np.float32)
    for k in range(n_kf):
        c, s = np.cos(gt_yaw[k]), np.sin(gt_yaw[k])
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        for pts, out, n in ((corner_pts, kf_corner, C), (surf_pts, kf_surf, S)):
            near = pts[np.linalg.norm(pts[:, :2] - gt_t[k, :2], axis=1) < 9.0]
            pick = near[g.choice(len(near), n, replace=False)]
            out[k] = (pick - gt_t[k]) @ R + g.normal(0, 0.01, (n, 3))
    state = jslam.SlamState.init(jcfg)
    ms = state.mapping
    live = np.arange(K) < n_kf
    kf_q = np.array(ms.kf_q)
    kf_q[:n_kf] = np.asarray(jax.vmap(jm3.ypr_to_quat)(jnp.asarray(est_ypr)))
    kf_t = np.zeros((K, 3), np.float32)
    kf_t[:n_kf] = est_t
    ms = ms.replace(
        kf_q=jnp.asarray(kf_q), kf_t=jnp.asarray(kf_t),
        kf_travel=jnp.asarray(np.where(live, np.arange(K) * KF_SPACING, 0.0), jnp.float32),
        kf_stamp=jnp.asarray(np.where(live, np.arange(K) * 0.5, 0.0), jnp.float32),
        kf_corner=jnp.asarray(kf_corner), kf_surf=jnp.asarray(kf_surf),
        kf_corner_mask=jnp.asarray(np.broadcast_to(live[:, None], (K, C))),
        kf_surf_mask=jnp.asarray(np.broadcast_to(live[:, None], (K, S))),
        kf_count=jnp.asarray(n_kf, jnp.int32),
        travel_dist=jnp.asarray((n_kf - 1) * KF_SPACING, jnp.float32),
        q_md=jnp.asarray(kf_q[n_kf - 1]), t_md=jnp.asarray(kf_t[n_kf - 1] * 0.01),
        q_w_last=jnp.asarray(kf_q[n_kf - 1]), t_w_last=jnp.asarray(kf_t[n_kf - 1]),
    )
    ls = jloop.LoopState.init(jcfg).replace(last_kf_count=jnp.asarray(n_kf - 3, jnp.int32))
    return state.replace(mapping=ms), ls


def _run_loop_step(jstate, jls, jcfg, tcfg):
    jout = jax.jit(functools.partial(jloop.loop_closure_step, cfg=jcfg))(jstate, jls)
    tout = tloop.loop_closure_step(bridge.state_from_numpy(_sd(jstate), tcfg, "cpu"),
                                   bridge.loop_state_from_numpy(_sd(jls), tcfg, "cpu"), tcfg)
    return jout, tout


def _assert_step_matches(jout, tout, pose_atol=1e-4):
    (js, jls, jinfo), (ts, tls, tinfo) = jout, tout
    for f in ("attempted", "accepted", "candidate", "pgo_ran"):
        assert getattr(tinfo, f).item() == np.asarray(getattr(jinfo, f)).item(), f
    assert tinfo.candidate.dtype == torch.int32
    jf, tf = float(jinfo.fitness), float(tinfo.fitness)
    assert abs(tf - jf) <= 1e-3 * abs(jf), (tf, jf)
    _assert_loop_states(tls, jls)
    t_np, j_np = bridge.state_to_numpy(ts), _sd(js)
    for k in ("mapping.kf_t", "mapping.kf_q", "mapping.t_md", "mapping.q_md",
              "mapping.t_w_last", "mapping.q_w_last"):
        np.testing.assert_allclose(t_np[k], j_np[k], atol=pose_atol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(t_np["mapping.kf_count"], j_np["mapping.kf_count"])


def _loop_residual(ms, ls, slot):
    """Norm of the loop's 4-DoF residual at the poses of ``ms``, yaw in
    degrees as the PGO weighs it."""
    i, j = int(ls.loop_i[slot]), int(ls.loop_j[slot])
    yaw = tm3.quat_to_ypr(ms.kf_q[[j, i]])[:, 0]
    r = tfac.fourdof_residual(yaw[0], ms.kf_t[j], yaw[1], ms.kf_t[i], ls.loop_t[slot],
                              ls.loop_yaw[slot], ls.loop_pitch_j[slot], ls.loop_roll_j[slot])
    return float(torch.linalg.norm(torch.cat([r[:3], r[3:] * tloop.RAD2DEG])))


@pytest.mark.parametrize("method", ["point", "gicp", "plane"])
def test_loop_closure_step_matches(method):
    """The latest keyframe revisits keyframe ~6 of a drifted circle: every
    method accepts the loop and the PGO moves the store, as in JAX."""
    jcfg, tcfg = _cfgs(loop_icp_method=method)
    jstate, jls = _circle_store(jcfg)
    jout, tout = _run_loop_step(jstate, jls, jcfg, tcfg)
    _assert_step_matches(jout, tout)
    ts, tls, tinfo = tout
    assert bool(tinfo.accepted) and int(tls.loop_count) == 1
    moved = np.abs(ts.mapping.kf_t.numpy() - np.asarray(jstate.mapping.kf_t)).max()
    assert moved > 0.02, moved
    # the PGO cuts the new loop's 4-DoF residual (what chip_smoke.py phase 5
    # holds the card's first loop to: at most half)
    before = bridge.state_from_numpy(_sd(jstate), tcfg, "cpu").mapping
    r_before, r_after = (_loop_residual(ms, tls, 0) for ms in (before, ts.mapping))
    assert r_after <= 0.5 * r_before, (r_before, r_after)


@pytest.mark.parametrize("store", ["empty", "no eligible keyframe"])
@pytest.mark.parametrize("method", ["point", "gicp", "plane"])
def test_loop_closure_step_without_candidate(method, store):
    """Nothing to close: no ICP runs, and the step returns JAX's masked
    result (fitness 0, nothing accepted, the store unchanged but for its
    keyframe watermark)."""
    jcfg, tcfg = _cfgs(loop_icp_method=method)
    if store == "empty":
        jstate, jls = jslam.SlamState.init(jcfg), jloop.LoopState.init(jcfg)
    else:
        jstate, jls = _circle_store(jcfg, n_kf=20)     # 19 m of travel: under the gate
    jout, tout = _run_loop_step(jstate, jls, jcfg, tcfg)
    _assert_step_matches(jout, tout, pose_atol=0)
    _, tls, tinfo = tout
    assert bool(tinfo.attempted) == (store != "empty")
    assert not bool(tinfo.accepted) and float(tinfo.fitness) == 0.0
    assert int(tls.loop_count) == 0 and int(tls.last_kf_count) == int(jstate.mapping.kf_count)


# ---------------------------------------------------------------------------
# the slice as a whole: SlamSystem with loops on
# ---------------------------------------------------------------------------

N_CARRY = 9            # scans before the one that reaches the cadence boundary
N_FILLER = 10


def _perturbed(scan, seed):
    g = np.random.default_rng(seed)
    s = dict(scan)
    s["xyz"] = (scan["xyz"] * (1 + 1e-7 * g.standard_normal(scan["xyz"].shape))).astype(np.float32)
    return s


def test_slam_system_closes_a_loop():
    """JAX state after 9 scans of tests/test_mapping.py's sequence, its
    keyframe store extended by 10 empty keyframes far away whose travel
    puts the real keyframes past the loop gates; scan 9 then reaches the
    cadence boundary (frame 10) in both packages, adds a keyframe that
    revisits the real ones, and the loop step accepts it and runs the PGO.
    ``loop_fitness_thresh`` is 0.15, as in tests/test_loop.py: the
    360-azimuth clouds of this config put the fitness at ~0.104, over the
    reference's 0.1 (measured in both packages)."""
    jcfg, tcfg = _cfgs(loop_cadence=N_CARRY + 1, loop_fitness_thresh=0.15)
    seq = synthetic.generate_sequence(
        n_scans=N_CARRY + 2, n_azimuth=360, seed=5, extent=18.0, radius=8.0,
        noise=0.004, motion_distortion=True, closes_loop=False, speed=2.0,
    )

    def j_inputs(k, scan=None):
        t_i, acc, gyr = seq["imu"][k]
        return (j_cloud(scan or seq["scans"][k], jcfg), j_imu(t_i, acc, gyr, jcfg.max_imu),
                seq["stamps"][k])

    step = jax.jit(functools.partial(jslam.slam_step, cfg=jcfg))
    state = jslam.SlamState.init(jcfg)
    for k in range(N_CARRY):
        cloud, imu, stamp = j_inputs(k)
        state, _ = step(state, cloud, imu, jnp.asarray(stamp, jnp.float32))
    ms = state.mapping
    n_real = int(ms.kf_count)
    kf_t, kf_travel = np.array(ms.kf_t), np.array(ms.kf_travel)
    kf_travel[:n_real] += 5.0                             # past the maturity gate
    for i in range(N_FILLER):                             # empty masks: no points
        kf_t[n_real + i] = [40.0 + 2 * i, 30.0, 0.0]
        kf_travel[n_real + i] = 12.0 + 4 * i
    state = state.replace(mapping=ms.replace(
        kf_t=jnp.asarray(kf_t), kf_travel=jnp.asarray(kf_travel),
        kf_count=jnp.asarray(n_real + N_FILLER, jnp.int32),
        travel_dist=jnp.asarray(kf_travel[n_real + N_FILLER - 1], jnp.float32)))

    def j_system(scan=None):
        system = jslam.SlamSystem(jcfg)
        system.state, system._frame = state, N_CARRY
        system.process(*j_inputs(N_CARRY, scan))
        return system

    jsys = j_system()
    env = max(np.abs(np.asarray(j_system(_perturbed(seq["scans"][N_CARRY], seed)).state.mapping.kf_t)
                     - np.asarray(jsys.state.mapping.kf_t)).max() for seed in (1, 2, 3))

    tsys = tslam.SlamSystem(tcfg, device="cpu")
    tsys.state, tsys._frame = bridge.state_from_numpy(_sd(state), tcfg, "cpu"), N_CARRY
    t_i, acc, gyr = seq["imu"][N_CARRY]
    tsys.process(t_cloud(seq["scans"][N_CARRY], tcfg, "cpu"),
                 t_imu(t_i, acc, gyr, tcfg.max_imu, "cpu"), seq["stamps"][N_CARRY])

    gate = max(1e-4, 2 * env)
    info = tsys.loop_info
    assert info is not None and bool(info.accepted) and bool(info.pgo_ran)
    assert int(tsys.loop_state.loop_count) == int(jsys.loop_state.loop_count) == 1
    _assert_loop_states(tsys.loop_state, jsys.loop_state, atol=gate)
    t_np, j_np = bridge.state_to_numpy(tsys.state), _sd(jsys.state)
    assert int(t_np["mapping.kf_count"]) == n_real + N_FILLER + 1
    for k in ("mapping.kf_t", "mapping.t_md", "mapping.t_w_last"):
        assert np.abs(t_np[k] - j_np[k]).max() <= gate, (k, np.abs(t_np[k] - j_np[k]).max(), env)
    n_old = n_real + N_FILLER
    moved = np.abs(t_np["mapping.kf_t"][:n_old] - kf_t[:n_old]).max()
    assert moved > 1e-3, moved                            # the PGO ran
    np.testing.assert_allclose(tsys.trajectory[-1][2], np.asarray(jsys.trajectory[-1][2]),
                               atol=gate)
