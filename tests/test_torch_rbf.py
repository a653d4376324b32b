"""``cov_estimation="rbf"`` in the port: ``ops/covariance.rbf_covariances``
and the front-end and step that use it, against JAX on the CPU.

The covariances are held row by row (tests/torch_cov_gates.py): each row
within the largest of rtol 1e-4 / atol 1e-5, twice JAX's own move of that
row under two 1e-7 relative perturbations of its scan (an rbf weight flips
at the 3 m cutoff wherever float32 rounding of the Gram-identity distance
crosses it; the plane regularizer turns a near-tie of the two smallest
eigenvalues into an arbitrary normal), and the float32 rounding of the
row's one-pass moments.  A row block (``row_start`` / ``row_count``) must
equal the same rows of the port's full result bit for bit, and the slam
steps tests/test_torch_slam.py's early-scan gate of 5e-3 m.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG0
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud, imu_from_interval as j_imu
from rgc_slam_tpu.models import slam as jslam
from rgc_slam_tpu.ops import covariance as jcov
from rgc_slam_tpu.ops import features as jf
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG0
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud, imu_from_interval as t_imu
from rgc_slam_tpu_torch.models import slam as tslam
from rgc_slam_tpu_torch.ops import covariance as tcov
from rgc_slam_tpu_torch.ops import features as tf
from torch_cov_gates import assert_rows_track, rbf_rounding, rows_max

torch.set_num_threads(1)
JCFG = dataclasses.replace(JCFG0, cov_estimation="rbf")
TCFG = dataclasses.replace(TCFG0, cov_estimation="rbf")
SEEDS = (1, 2)


def _perturb(x, seed):
    g = np.random.default_rng(seed)
    return (x * (1 + 1e-7 * g.standard_normal(x.shape))).astype(np.float32)


@pytest.fixture(scope="module")
def organized():
    """The organized cloud of tests/test_features_sp.py's scan (4096 slots,
    ~3100 unmasked), as numpy."""
    rng = np.random.default_rng(42)
    world = synthetic.default_world(seed=3, extent=18.0)
    scan = synthetic.cast_scan(world, np.eye(3), np.array([0.3, -0.2, 0.56]),
                               n_rings=16, n_azimuth=220, rng=rng, noise=0.01)
    org = jf._organize_preamble(j_cloud(scan, JCFG), JCFG)[0]
    return np.array(org.xyz), np.array(org.mask), scan


@pytest.mark.parametrize("method", ["none", "plane"])
def test_rbf_covariances_full_cloud(organized, method):
    xyz, mask, _ = organized
    fn = jax.jit(functools.partial(jcov.rbf_covariances, method=method))
    ref = np.asarray(fn(jnp.asarray(xyz), jnp.asarray(mask)))
    own = np.max([rows_max(np.asarray(fn(jnp.asarray(_perturb(xyz, s)), jnp.asarray(mask))) - ref)
                  for s in SEEDS], 0)
    got = tcov.rbf_covariances(torch.from_numpy(xyz), torch.from_numpy(mask),
                               method=method).numpy()
    assert got.shape == ref.shape == (len(xyz), 3, 3) and np.isfinite(got).all()
    assert_rows_track(got, ref, own, rbf_rounding(xyz, mask, method))
    np.testing.assert_array_equal(got[~mask], ref[~mask])   # masked rows: regularized identity


def test_rbf_covariances_row_block(organized):
    """A block of query rows equals the same rows of the full result (the
    keys stay the whole cloud), in each package, with a chunk that does not
    divide the block."""
    xyz, mask, _ = organized
    x, m = torch.from_numpy(xyz), torch.from_numpy(mask)
    full = tcov.rbf_covariances(x, m, row_chunk=1000).numpy()
    block = tcov.rbf_covariances(x, m, row_chunk=1000, row_start=2048, row_count=1024).numpy()
    np.testing.assert_array_equal(block, full[2048:3072])
    jblock = np.asarray(jcov.rbf_covariances(jnp.asarray(xyz), jnp.asarray(mask),
                                             row_start=2048, row_count=1024))
    jfull = np.asarray(jcov.rbf_covariances(jnp.asarray(xyz), jnp.asarray(mask)))
    np.testing.assert_array_equal(jblock, jfull[2048:3072])
    # so the block is held to JAX's as its rows of the full cloud are
    np.testing.assert_array_equal(block - jblock, (full - jfull)[2048:3072])


def test_extract_features_rbf(organized):
    xyz, mask, scan = organized
    fn = jax.jit(functools.partial(jf.extract_features, cfg=JCFG))
    jc = j_cloud(scan, JCFG)
    jfx = fn(jc)
    ref = np.asarray(jfx.normals_cov)
    own = np.max([rows_max(np.asarray(fn(jc.replace(xyz=jnp.asarray(
        _perturb(np.asarray(jc.xyz), s)))).normals_cov) - ref) for s in SEEDS], 0)
    got = tf.extract_features(t_cloud(scan, TCFG, "cpu"), TCFG)
    assert_rows_track(got.normals_cov.numpy(), ref, own,
                      rbf_rounding(xyz, mask, TCFG.cov_regularization))
    for name in ("sharp", "flat", "inten"):       # the covariances feed no pick
        np.testing.assert_array_equal(getattr(got, name).mask.numpy(),
                                      np.asarray(getattr(jfx, name).mask))


def test_slam_steps_rbf():
    """Three slam_steps of tests/test_torch_slam.py's sequence with rbf
    covariances: t_map within its early-scan gate of JAX's."""
    seq = synthetic.generate_sequence(
        n_scans=31, n_azimuth=360, seed=5, extent=18.0, radius=8.0,
        noise=0.004, motion_distortion=True, closes_loop=False, speed=2.0,
    )
    step = jax.jit(functools.partial(jslam.slam_step, cfg=JCFG))
    jstate, tstate = jslam.SlamState.init(JCFG), tslam.SlamState.init(TCFG, "cpu")
    for k in range(3):
        t_i, acc, gyr = seq["imu"][k]
        jstate, jout = step(jstate, j_cloud(seq["scans"][k], JCFG),
                            j_imu(t_i, acc, gyr, JCFG.max_imu),
                            jnp.asarray(seq["stamps"][k], jnp.float32))
        tstate, tout = tslam.slam_step(
            tstate, t_cloud(seq["scans"][k], TCFG, "cpu"), t_imu(t_i, acc, gyr, TCFG.max_imu, "cpu"),
            torch.tensor(seq["stamps"][k], dtype=torch.float32), TCFG)
        assert np.isfinite(tout.t_map.numpy()).all()
        assert np.abs(tout.t_map.numpy() - np.asarray(jout.t_map)).max() < 5e-3, k
        assert bool(tout.kf_added) == bool(jout.kf_added)
