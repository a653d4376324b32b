"""Degenerate inputs through the port against JAX: the scenarios of
tests/test_robustness.py (same seeds, TEST_CONFIG, inputs), here the first
three: a fully masked scan followed by one with NaN xyz in its masked slots,
duplicate and out-of-order IMU stamps, and scan stamps that go backwards.
tests/test_torch_robustness_fleet.py holds the other three.

Each scenario runs the same inputs through JAX's ``slam_step`` and the
port's.  Every scan's pose must be finite in both, and the port's ``t_map``
within tests/test_torch_slam.py's gate of JAX's, axis by axis: 5e-3 m until
JAX's own deviation on that axis grows past half of it, then twice the
largest deviation of JAX from itself on that axis so far, when every
scan's coordinates are perturbed by 1e-7 relative (two seeds).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from rgc_slam_tpu import types as jtypes
from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud, imu_from_interval as j_imu
from rgc_slam_tpu.models import slam as jslam
from rgc_slam_tpu_torch import types as ttypes
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.models import slam as tslam

torch.set_num_threads(1)
PERTURB_SEEDS = (1, 2)
CLOUD = ("xyz", "intensity", "rel_time", "ring", "mask")
IMU = ("t", "acc", "gyr", "mask")


def as_numpy(cloud, imu, stamp):
    """One scan's inputs as numpy: (cloud fields, imu fields, stamp)."""
    return ({k: np.array(getattr(cloud, k)) for k in CLOUD},
            {k: np.array(getattr(imu, k)) for k in IMU}, np.float32(stamp))


def seq_inputs(seq, k, cfg=JCFG):
    t_i, acc, gyr = seq["imu"][k]
    return j_cloud(seq["scans"][k], cfg), j_imu(t_i, acc, gyr, cfg.max_imu), seq["stamps"][k]


def perturbed(scan, seed):
    cloud, imu, stamp = scan
    g = np.random.default_rng(seed)
    xyz = (cloud["xyz"] * (1 + 1e-7 * g.standard_normal(cloud["xyz"].shape))).astype(np.float32)
    return dict(cloud, xyz=xyz), imu, stamp


def jax_args(scan):
    cloud, imu, stamp = scan
    return (jtypes.PointCloud(**{k: jnp.asarray(v) for k, v in cloud.items()}),
            jtypes.ImuBatch(**{k: jnp.asarray(v) for k, v in imu.items()}),
            jnp.asarray(stamp, jnp.float32))


def port_args(scan):
    cloud, imu, stamp = scan
    return (ttypes.PointCloud(**{k: torch.from_numpy(v) for k, v in cloud.items()}),
            ttypes.ImuBatch(**{k: torch.from_numpy(v) for k, v in imu.items()}),
            torch.tensor(stamp, dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def jax_step(cfg=JCFG):
    return jax.jit(functools.partial(jslam.slam_step, cfg=cfg))


def finite_state(q_w, t_w, q_md) -> bool:
    return all(np.isfinite(np.asarray(x)).all() for x in (q_w, t_w, q_md))


def run_jax(scans, cfg=JCFG, watch=None):
    """JAX's trajectory over ``scans``, its final state and, per scan,
    ``watch(state)`` (None: nothing)."""
    state, traj, seen = jslam.SlamState.init(cfg), [], []
    for k, scan in enumerate(scans):
        state, out = jax_step(cfg)(state, *jax_args(scan))
        assert finite_state(state.odo.q_w, state.odo.t_w, state.mapping.q_md), f"JAX, scan {k}"
        traj.append(np.asarray(out.t_map))
        seen.append(watch(state) if watch else None)
    return np.stack(traj), state, seen


def run_port(scans, cfg=TCFG, watch=None):
    state, traj, seen = tslam.SlamState.init(cfg, "cpu"), [], []
    for k, scan in enumerate(scans):
        state, out = tslam.slam_step(state, *port_args(scan), cfg)
        assert finite_state(state.odo.q_w, state.odo.t_w, state.mapping.q_md), f"port, scan {k}"
        traj.append(out.t_map.numpy())
        seen.append(watch(state) if watch else None)
    return np.stack(traj), state, seen


def assert_tracks_jax(scans, jcfg=JCFG, tcfg=TCFG, watch=None, seeds=PERTURB_SEEDS):
    """The port's trajectory against JAX's under the module's gate (JAX's
    own deviation over ``seeds``), axis by axis: an axis the scene leaves
    unobserved loosens no other.  Returns (port trajectory, JAX trajectory,
    port final state, (port, JAX) per-scan ``watch`` values)."""
    ref, _, jseen = run_jax(scans, jcfg, watch)
    env = np.zeros(ref.shape)
    for seed in seeds:
        moved = run_jax([perturbed(s, seed) for s in scans], jcfg)[0]
        env = np.maximum(env, np.abs(moved - ref))
    got, state, tseen = run_port(scans, tcfg, watch)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    dev = np.abs(got - ref)
    gate = np.maximum(5e-3, 2 * np.maximum.accumulate(env, axis=0))
    assert (dev <= gate).all(), (np.flatnonzero(dev > gate), dev, gate)
    return got, ref, state, (tseen, jseen)


def test_empty_and_garbage_scans_mid_run():
    """Scan 3 fully masked, scan 4 with NaN xyz in its masked slots: both
    packages stay finite through scan 8 and resume tracking."""
    seq = synthetic.generate_sequence(
        n_scans=9, n_azimuth=240, seed=31, extent=16.0, radius=6.0,
        noise=0.004, closes_loop=False, speed=1.5,
    )
    scans = []
    for k in range(len(seq["scans"])):
        cloud, imu, stamp = seq_inputs(seq, k)
        if k == 3:
            cloud = cloud.replace(mask=jnp.zeros_like(cloud.mask))
        if k == 4:
            cloud = cloud.replace(xyz=jnp.where(cloud.mask[:, None], cloud.xyz, jnp.nan))
        scans.append(as_numpy(cloud, imu, stamp))
    assert np.isnan(scans[4][0]["xyz"]).any()
    got = assert_tracks_jax(scans)[0]
    gt = np.stack([t for (_, t) in seq["poses"]])
    assert np.linalg.norm((got[-1] - got[-3]) - (gt[-1] - gt[-3])) < 0.5


def test_out_of_order_and_duplicate_imu_stamps():
    seq = synthetic.generate_sequence(
        n_scans=7, n_azimuth=240, seed=33, extent=16.0, radius=6.0,
        noise=0.004, closes_loop=False, speed=1.5,
    )
    scans = []
    for k in range(len(seq["scans"])):
        t_imu, acc, gyr = seq["imu"][k]
        if k == 2:          # duplicate stamps: every sample delivered twice
            t_imu = np.repeat(t_imu[: len(t_imu) // 2], 2)
            acc = np.repeat(acc[: len(acc) // 2], 2, axis=0)
            gyr = np.repeat(gyr[: len(gyr) // 2], 2, axis=0)
        if k == 4:          # out of order: swap interior pairs
            idx = np.arange(len(t_imu))
            idx[1:-1:2], idx[2:-1:2] = idx[2:-1:2].copy(), idx[1:-1:2].copy()
            t_imu, acc, gyr = t_imu[idx], acc[idx], gyr[idx]
        scans.append(as_numpy(j_cloud(seq["scans"][k], JCFG),
                              j_imu(t_imu, acc, gyr, JCFG.max_imu), seq["stamps"][k]))
    assert_tracks_jax(scans)


def test_backwards_scan_stamps():
    seq = synthetic.generate_sequence(
        n_scans=6, n_azimuth=240, seed=34, extent=16.0, radius=6.0,
        noise=0.004, closes_loop=False, speed=1.5,
    )
    stamps = [0.1, 0.2, 0.3, 0.15, 0.15, 0.5]   # backwards + duplicate
    scans = [as_numpy(*seq_inputs(seq, k)[:2], stamps[k]) for k in range(len(seq["scans"]))]
    assert_tracks_jax(scans)


def test_linalg_sites_take_non_finite_input():
    """The four torch.linalg sites of the step that raise on NaN where
    jnp.linalg returns NaN: the ground plane's eigh, the loop ICP's SVD, the
    degeneracy projection's eigh and the frobenius regularizer's inverses.
    Each now returns what JAX returns (NaN where JAX's is NaN) and raises
    nothing."""
    from rgc_slam_tpu.models import loop as jloop
    from rgc_slam_tpu.ops import covariance as jcov
    from rgc_slam_tpu.ops import factors as jfac
    from rgc_slam_tpu.ops import features as jfeat
    from rgc_slam_tpu_torch.models import loop as tloop
    from rgc_slam_tpu_torch.ops import covariance as tcov
    from rgc_slam_tpu_torch.ops import factors as tfac
    from rgc_slam_tpu_torch.ops import features as tfeat

    g = np.random.default_rng(0)
    xyz = g.normal(size=(64, 3)).astype(np.float32)
    xyz[:8] = np.nan                                   # rows of weight 0
    w = np.where(np.arange(64) < 8, 0.0, 1.0).astype(np.float32)
    jg = jfeat._ground_solve(jnp.asarray(xyz), jnp.asarray(w), jnp.asarray(w), JCFG, jnp.float32)
    tg = tfeat._ground_solve(torch.from_numpy(xyz), torch.from_numpy(w), torch.from_numpy(w),
                             TCFG, torch.float32)
    assert not bool(tg.valid) and not bool(jg.valid)
    for f in ("normal", "v1", "v2", "distance"):
        np.testing.assert_array_equal(np.isnan(getattr(tg, f).numpy()),
                                      np.isnan(np.asarray(getattr(jg, f))), err_msg=f)

    # loop ICP: a NaN source point poisons the centroids and so H's SVD
    tgt = g.normal(size=(32, 3)).astype(np.float32)
    src = tgt.copy()
    src[0] = np.nan
    m = np.ones(32, bool)
    jq, jt, _, _ = jloop.icp_point2point(jnp.asarray(src), jnp.asarray(m), jnp.asarray(tgt),
                                         jnp.asarray(m), 1.0, 3)
    tq, tt, _, _ = tloop.icp_point2point(torch.from_numpy(src), torch.from_numpy(m),
                                         torch.from_numpy(tgt), torch.from_numpy(m), 1.0, 3)
    assert np.isnan(np.asarray(jq)).all()
    np.testing.assert_array_equal(np.isnan(tq.numpy()), np.isnan(np.asarray(jq)))
    np.testing.assert_array_equal(np.isnan(tt.numpy()), np.isnan(np.asarray(jt)))

    A = g.normal(size=(10, 6)).astype(np.float32)
    A[3, 2] = np.nan
    jP, _ = jfac.degeneracy_projection(lambda x: jnp.asarray(A) @ x, 6, 1e-3)
    tP, _ = tfac.degeneracy_projection(lambda x, c: c["A"] @ x, 6, 1e-3,
                                       {"A": torch.from_numpy(A)})
    np.testing.assert_array_equal(np.isnan(tP.numpy()), np.isnan(np.asarray(jP)))

    cov = np.stack([np.diag([1.0, -1e-3, 1.0]), np.full((3, 3), np.nan)]).astype(np.float32)
    tr = tcov.frobenius_regularize(torch.from_numpy(cov)).numpy()
    jr = np.asarray(jcov.frobenius_regularize(jnp.asarray(cov)))
    np.testing.assert_array_equal(np.isfinite(tr[0]), np.isfinite(jr[0]))
    np.testing.assert_allclose(tr[0][np.isfinite(tr[0])], jr[0][np.isfinite(jr[0])], rtol=1e-5)
    assert np.isnan(tr[1]).all() and np.isnan(jr[1]).any()
