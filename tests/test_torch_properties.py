"""tests/test_properties.py's eight hypothesis invariants through the port,
each held to the JAX package on the same draw.

Every property draws with the JAX file's strategies, asserts the JAX
file's invariant on the port's result with the JAX file's tolerance, and
holds the port's result to JAX's on the same draw:

* the math3d four (quat_exp/quat_log, quat_rotate's norm, se3_compose /
  se3_apply associativity, ypr_to_mat / mat_to_ypr): within 1e-5 absolute
  of JAX, and within 1e-5 x |v| for the points the strategy draws up to
  100 m out (float32 spaces values past 64 by 7.6e-6, so 1e-5 absolute
  would ask the rotated points for bit equality);
* voxel-hash claiming: keys, ``slot_of_point``, ``table_keys`` and the
  lookups equal to JAX's exactly.  The draw is widened to coordinates up to
  ±5000 m: every non-zero key wraps ``_hash_key``'s int32 multiply
  (rgc_slam_tpu/ops/voxelhash.py:71-80), and coordinates past ±512 voxels
  pack to the empty key (two explicit examples hold a 1000 m and a 5000 m
  draw whatever the derandomized draws are);
* ``eigh3x3``: eigenvalues within 1e-5 x max|S| of JAX's; eigenvectors
  within 1e-3 of JAX's column by column, up to sign (the JAX test's
  reconstruction gate is 5e-3 of max|S|);
* ``preintegrate_full`` against ``preintegrate``: the port's full and light
  means within 1e-6 of each other and of JAX's;
* the PGO's pin and chain consistency: the pinned keyframe exact in both
  packages, the loop residual not increased, every pose within 1e-4 m of
  JAX's.

``derandomize=True`` (and no example database): every run draws the same
examples.  Each property takes the JAX file's example count but the
voxel-hash one, which the JAX file marks ``slow``: JAX compiles the table
anew for every point count drawn, so Tier-1 takes 5 draws and two explicit
examples, and its ``slow`` variant the JAX file's 20.  The
JAX side of the preintegration and the PGO runs under ``jax.jit`` (one
compile for all draws).
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.models import loop as jloop
from rgc_slam_tpu.models.mapping import MappingState as JMappingState
from rgc_slam_tpu.ops import imu as jimu
from rgc_slam_tpu.ops import voxelhash as jvh
from rgc_slam_tpu.ops.covariance import eigh3x3 as j_eigh3x3
from rgc_slam_tpu.types import ImuBatch as JImuBatch
from rgc_slam_tpu.utils import math3d as jm3
from rgc_slam_tpu_torch import bridge
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.models import loop as tloop
from rgc_slam_tpu_torch.models.mapping import MappingState as TMappingState
from rgc_slam_tpu_torch.ops import imu as timu
from rgc_slam_tpu_torch.ops import voxelhash as tvh
from rgc_slam_tpu_torch.ops.covariance import eigh3x3 as t_eigh3x3
from rgc_slam_tpu_torch.types import ImuBatch as TImuBatch
from rgc_slam_tpu_torch.utils import math3d as tm3

torch.set_num_threads(1)
AGREE = 1e-5                     # the math3d four against JAX (x |v| for points)

finite = st.floats(-100.0, 100.0, allow_nan=False, allow_infinity=False)
angle = st.floats(-3.1, 3.1, allow_nan=False)
small = st.floats(-1.0, 1.0, allow_nan=False)


def vec3(draw_from=finite):
    return st.tuples(draw_from, draw_from, draw_from).map(lambda t: np.asarray(t, np.float32))


def steady(max_examples):
    return settings(max_examples=max_examples, deadline=None, derandomize=True, database=None)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _agree(t, j, atol=AGREE):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# math3d
# ---------------------------------------------------------------------------


@steady(30)
@given(w=vec3(small))
def test_exp_log_inverse(w):
    jw, tw = _both(w)
    q, jq = tm3.quat_exp(tw), jm3.quat_exp(jw)
    log = tm3.quat_log(q)
    np.testing.assert_allclose(log.numpy(), w, atol=1e-4)
    assert abs(float(torch.linalg.norm(q)) - 1.0) < 1e-5
    _agree(q, jq)
    _agree(log, jm3.quat_log(jq))


@steady(30)
@given(w=vec3(small), v=vec3())
def test_rotation_preserves_norm(w, v):
    (jw, tw), (jv, tv) = _both(w), _both(v)
    rv = tm3.quat_rotate(tm3.quat_exp(tw), tv)
    np.testing.assert_allclose(float(torch.linalg.norm(rv)), float(np.linalg.norm(v)),
                               rtol=1e-4, atol=1e-3)
    _agree(rv, jm3.quat_rotate(jm3.quat_exp(jw), jv), AGREE * max(1.0, float(np.abs(v).max())))


@steady(30)
@given(w1=vec3(small), w2=vec3(small), v=vec3())
def test_compose_associative_on_points(w1, w2, v):
    t1 = np.asarray([1.0, -2.0, 0.5], np.float32)
    t2 = np.asarray([0.3, 0.0, -1.0], np.float32)
    out = {}
    for name, m3, cast in (("jax", jm3, jnp.asarray), ("port", tm3, lambda x: torch.from_numpy(x))):
        q1, q2 = m3.quat_exp(cast(w1)), m3.quat_exp(cast(w2))
        qc, tc = m3.se3_compose(q1, cast(t1), q2, cast(t2))
        a = m3.se3_apply(qc, tc, cast(v))
        b = m3.se3_apply(q1, cast(t1), m3.se3_apply(q2, cast(t2), cast(v)))
        out[name] = (np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(out["port"][0], out["port"][1], atol=1e-3)
    scale = AGREE * max(1.0, float(np.abs(v).max()))
    _agree(out["port"][0], out["jax"][0], scale)
    _agree(out["port"][1], out["jax"][1], scale)


@steady(30)
@given(ypr=st.tuples(angle, st.floats(-1.4, 1.4), st.floats(-1.4, 1.4)))
def test_ypr_matrix_roundtrip(ypr):
    y = np.asarray(ypr, np.float32)
    jy, ty = _both(y)
    R = tm3.ypr_to_mat(ty)
    np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-5)
    back = tm3.mat_to_ypr(R)
    np.testing.assert_allclose(back.numpy(), y, atol=1e-4)
    jR = jm3.ypr_to_mat(jy)
    _agree(R, jR)
    _agree(back, jm3.mat_to_ypr(jR))


# ---------------------------------------------------------------------------
# voxel-hash claiming
# ---------------------------------------------------------------------------


def _claiming(seed, n, res, extent):
    pts = np.random.default_rng(seed).uniform(-extent, extent, (n, 3)).astype(np.float32)
    jp, tp = _both(pts)
    jkeys = jvh.pack_coords(jvh.voxel_coords(jp, res), jnp.ones(n, bool))
    keys = tvh.pack_coords(tvh.voxel_coords(tp, res), torch.ones(n, dtype=torch.bool))
    jht, ht = jvh.build_hash_table(jkeys, cap=1024), tvh.build_hash_table(keys, cap=1024)
    found = tvh.lookup_slots(ht.table_keys, keys).numpy()
    keys_np, slots, table = keys.numpy(), ht.slot_of_point.numpy(), ht.table_keys.numpy()
    # the JAX test's invariants on the port's table
    ok = slots >= 0
    assert (table[slots[ok]] == keys_np[ok]).all()
    for k in np.unique(keys_np):
        assert len(np.unique(slots[keys_np == k])) == 1
    assert (found[ok] == slots[ok]).all()
    # JAX's, exactly
    np.testing.assert_array_equal(keys_np, np.asarray(jkeys))
    np.testing.assert_array_equal(slots, np.asarray(jht.slot_of_point))
    np.testing.assert_array_equal(table, np.asarray(jht.table_keys))
    np.testing.assert_array_equal(found, np.asarray(jvh.lookup_slots(jht.table_keys, jkeys)))


CLAIM_DRAW = dict(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 300),
                  res=st.sampled_from([0.25, 0.5, 1.0, 2.0]),
                  extent=st.sampled_from([50.0, 1000.0, 5000.0]))


@steady(5)
@given(**CLAIM_DRAW)
@example(seed=1, n=300, res=2.0, extent=1000.0)      # in range: keys up to 2^30
@example(seed=2, n=300, res=0.25, extent=5000.0)     # mostly past ±512 voxels: empty keys
def test_voxelhash_claiming_invariants(seed, n, res, extent):
    _claiming(seed, n, res, extent)


@pytest.mark.slow
@steady(20)
@given(**CLAIM_DRAW)
def test_voxelhash_claiming_invariants_full(seed, n, res, extent):
    _claiming(seed, n, res, extent)


# ---------------------------------------------------------------------------
# eigh3x3
# ---------------------------------------------------------------------------


@steady(20)
@given(seed=st.integers(0, 2**31 - 1))
def test_eigh3x3_reconstruction(seed):
    A = np.random.default_rng(seed).normal(size=(3, 3)).astype(np.float32)
    S = A @ A.T + 0.01 * np.eye(3, dtype=np.float32)
    jS, tS = _both(S)
    evals, evecs = (x.numpy() for x in t_eigh3x3(tS))
    R = evecs @ np.diag(evals) @ evecs.T
    scale = max(1.0, float(np.abs(S).max()))
    assert np.abs(R - S).max() / scale < 5e-3
    assert (np.diff(evals) >= -1e-4).all(), "ascending order"
    jvals, jvecs = (np.asarray(x) for x in j_eigh3x3(jS))
    assert np.abs(evals - jvals).max() <= 1e-5 * float(np.abs(S).max())
    sign = np.where((evecs * jvecs).sum(0) < 0, -1.0, 1.0)
    assert np.abs(evecs * sign - jvecs).max() <= 1e-3


# ---------------------------------------------------------------------------
# preintegration
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _jax_preintegrate_full():
    return jax.jit(jimu.preintegrate_full)


def _preintegration(seed):
    """tests/test_properties.py's masked IMU window through both packages."""
    rng = np.random.default_rng(seed)
    m = 24
    arrays = dict(t=(0.005 * (1 + np.arange(m))).astype(np.float32),
                  acc=rng.normal([0, 0, 9.81], 0.5, (m, 3)).astype(np.float32),
                  gyr=rng.normal(0, 0.3, (m, 3)).astype(np.float32),
                  mask=rng.random(m) > 0.2)
    ba = rng.normal(0, 0.05, 3).astype(np.float32)
    bg = rng.normal(0, 0.01, 3).astype(np.float32)
    jargs = (JImuBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}), jnp.asarray(0.0),
             jnp.asarray(0.15), jnp.asarray(ba), jnp.asarray(bg))
    targs = (TImuBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
             torch.tensor(0.0), torch.tensor(0.15), torch.from_numpy(ba), torch.from_numpy(bg))
    lite, full = timu.preintegrate(*targs), timu.preintegrate_full(*targs)
    jfull = _jax_preintegrate_full()(*jargs)
    for f in ("delta_q", "delta_p"):
        np.testing.assert_allclose(getattr(full, f).numpy(), getattr(lite, f).numpy(), atol=1e-6)
        np.testing.assert_allclose(getattr(full, f).numpy(), np.asarray(getattr(jfull, f)),
                                   atol=1e-6, rtol=0)
    cov = full.cov.numpy()
    np.testing.assert_allclose(cov, cov.T, atol=1e-9)
    assert np.linalg.eigvalsh(cov).min() > -1e-8
    assert np.isfinite(full.jac.numpy()).all()


@steady(15)
@given(seed=st.integers(0, 10_000))
def test_preintegration_cov_psd_and_mean_parity(seed):
    _preintegration(seed)


# ---------------------------------------------------------------------------
# the PGO
# ---------------------------------------------------------------------------

PGO_JCFG = dataclasses.replace(JCFG, max_keyframes=48, max_loops=4)
PGO_TCFG = dataclasses.replace(TCFG, max_keyframes=48, max_loops=4)


@functools.lru_cache(maxsize=1)
def _jax_pgo():
    return jax.jit(functools.partial(jloop._pgo_solve, cfg=PGO_JCFG))


def _state_dict(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in leaves}


def _pgo(seed):
    """tests/test_properties.py's drifted chain with one exact loop, solved
    by both packages."""
    rng = np.random.default_rng(seed)
    K = 32
    ms = JMappingState.init(PGO_JCFG)
    gt_t = np.stack([np.arange(K) * 1.0, np.zeros(K), np.zeros(K)], 1)
    est_t = gt_t + np.cumsum(rng.normal(0, 0.05, (K, 3)), axis=0)
    est_yaw = np.cumsum(rng.normal(0, 0.01, K))
    q = np.asarray(jm3.ypr_to_quat(jnp.asarray(
        np.stack([est_yaw, np.zeros(K), np.zeros(K)], 1), jnp.float32)))
    ms = ms.replace(
        kf_q=ms.kf_q.at[:K].set(q),
        kf_t=ms.kf_t.at[:K].set(jnp.asarray(est_t, jnp.float32)),
        kf_count=jnp.asarray(K, jnp.int32),
        kf_travel=ms.kf_travel.at[:K].set(jnp.arange(K, dtype=jnp.float32)),
    )
    ls = jloop.LoopState.init(PGO_JCFG)
    i, j = K - 1, 5
    rel_t = np.asarray(gt_t[i] - gt_t[j], np.float32)
    ls = ls.replace(loop_i=ls.loop_i.at[0].set(i), loop_j=ls.loop_j.at[0].set(j),
                    loop_t=ls.loop_t.at[0].set(jnp.asarray(rel_t)),
                    loop_count=jnp.asarray(1, jnp.int32))
    jout = _jax_pgo()(ms, ls)
    tms = bridge.tree_from_numpy(TMappingState.init(PGO_TCFG, "cpu"), _state_dict(ms), "cpu")
    tout = tloop._pgo_solve(tms, bridge.loop_state_from_numpy(_state_dict(ls), PGO_TCFG, "cpu"),
                            PGO_TCFG)
    kf_t, kf_q = tout.kf_t.numpy(), tout.kf_q.numpy()
    pinned = np.asarray(est_t[j], np.float32)
    # the pinned keyframe (the oldest loop's anchor j) keeps its pose exactly
    np.testing.assert_array_equal(kf_t[j], pinned)
    np.testing.assert_array_equal(np.asarray(jout.kf_t[j]), pinned)

    def loop_err(t, quats):
        yaw_j = float(tm3.quat_to_ypr(torch.from_numpy(np.array(quats[j])))[0])
        c, s = np.cos(yaw_j), np.sin(yaw_j)
        Rj = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        return np.linalg.norm(Rj.T @ (t[i] - t[j]) - rel_t)

    assert loop_err(kf_t[:K], kf_q[:K]) <= loop_err(est_t, q) + 1e-3
    np.testing.assert_allclose(kf_t, np.asarray(jout.kf_t), atol=1e-4, rtol=0)


@steady(10)
@given(seed=st.integers(0, 10_000))
def test_pgo_pin_and_chain_consistency(seed):
    _pgo(seed)
