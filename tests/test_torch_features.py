"""ops/features (and the covariances it calls) of the port against JAX.

Every array of ``extract_features(debug=True)`` is compared on synthetic
scans at TEST_CONFIG: masks, picks and ring tables exactly; floats at
1e-4 relative / 1e-4 absolute (the same float32 window sums in both
packages; 1e-4 is the JAX suite's ground-fit oracle gate).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud
from rgc_slam_tpu.ops import covariance as jcov
from rgc_slam_tpu.ops import features as jf
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud
from rgc_slam_tpu_torch.ops import covariance as tcov
from rgc_slam_tpu_torch.ops import features as tf

torch.set_num_threads(1)
RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def scans():
    seq = synthetic.generate_sequence(
        n_scans=4, n_azimuth=360, seed=5, extent=18.0, radius=8.0,
        noise=0.004, motion_distortion=True, closes_loop=False, speed=2.0,
    )
    return seq["scans"]


def _np(x):
    return np.asarray(x)


def _same(j, t, name):
    j, t = _np(j), _np(t)
    assert j.shape == t.shape, name
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j, err_msg=name)
    else:
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("i", [0, 2])
def test_extract_features_debug_matches(scans, i):
    jfx, jdbg = jf.extract_features(j_cloud(scans[i], JCFG), JCFG, debug=True)
    tfx, tdbg = tf.extract_features(t_cloud(scans[i], TCFG, "cpu"), TCFG, debug=True)
    assert set(jdbg) == set(tdbg)
    for k in jdbg:
        _same(jdbg[k], tdbg[k], k)
    assert int(_np(jdbg["sharp_picked"]).sum()) > 10
    assert int(_np(jdbg["flat_picked"]).sum()) > 10
    for name in ("sharp", "flat", "inten"):
        jc, tc = getattr(jfx, name), getattr(tfx, name)
        for fld in ("xyz", "rel_time", "confidence", "mask"):
            _same(getattr(jc, fld), getattr(tc, fld), f"{name}.{fld}")
    _same(jfx.ground_mask, tfx.ground_mask, "ground_mask")
    _same(jfx.ground.valid, tfx.ground.valid, "ground.valid")
    for fld in ("distance", "source"):
        _same(getattr(jfx.ground, fld), getattr(tfx.ground, fld), f"ground.{fld}")
    # eigenvector signs are LAPACK's choice; the engine uses |v.n| and a
    # sign-fixed normal, so compare up to sign
    for fld in ("normal", "v1", "v2"):
        jv, tv = _np(getattr(jfx.ground, fld)), _np(getattr(tfx.ground, fld))
        assert min(np.abs(jv - tv).max(), np.abs(jv + tv).max()) < 1e-4, fld
    _check_covariances(scans[i], jfx, tfx)


def _check_covariances(scan, jfx, tfx):
    """Raw scan covariances everywhere (1e-5 absolute + relative); the plane-regularized
    ones (2e-4) where the smallest eigenvalue is separated from the middle
    one — where it is not, the plane normal is ill-defined and float32
    rounding picks any vector of the degenerate pair in either package."""
    cfg_raw = JCFG.__class__(**{**JCFG.__dict__, "cov_regularization": "none"})
    org, _, _, pos, cnt = jf._organize_preamble(j_cloud(scan, JCFG), JCFG)
    j_raw = _np(jcov.scan_covariances(org.xyz, org.mask, org.ring, pos, cnt, cfg_raw))
    torg, _, _, tpos, tcnt = tf._organize_preamble(t_cloud(scan, TCFG, "cpu"), TCFG)
    t_raw = _np(tcov.scan_covariances(torg.xyz, torg.mask, torg.ring, tpos, tcnt,
                                      TCFG.__class__(**{**TCFG.__dict__,
                                                        "cov_regularization": "none"})))
    np.testing.assert_allclose(t_raw, j_raw, atol=1e-5, rtol=1e-5)
    ev = np.linalg.eigvalsh(j_raw.astype(np.float64))
    separated = (ev[:, 1] - ev[:, 0]) > 1e-2 * ev[:, 2]
    assert separated[_np(org.mask)].mean() > 0.7
    np.testing.assert_allclose(_np(tfx.normals_cov)[separated],
                               _np(jfx.normals_cov)[separated], atol=2e-4, rtol=0)


def test_eigh3x3_and_regularizers(rng):
    """Well-separated spectra (eigenvectors defined) to 1e-4; the isotropic
    branch and the all-zero matrix (the ``p`` floor) exactly."""
    V = np.linalg.qr(rng.normal(size=(512, 3, 3)))[0]
    lam = np.stack([rng.uniform(0.01, 0.1, 512), rng.uniform(0.5, 1.0, 512),
                    rng.uniform(2.0, 4.0, 512)], 1)
    A = np.einsum("nik,nk,njk->nij", V, lam, V).astype(np.float32)
    A[:8] = np.eye(3, dtype=np.float32) * 0.3
    A[8:16] = 0.0
    je, jV = jcov.eigh3x3(jnp.asarray(A))
    te, tV = tcov.eigh3x3(torch.from_numpy(A))
    np.testing.assert_allclose(_np(te), _np(je), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tV), _np(jV), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(_np(tV)[:16], _np(jV)[:16])
    for m in ("plane", "min_eig", "norm_min_eig", "frobenius", "none"):
        np.testing.assert_allclose(
            _np(tcov.regularize_covariances(torch.from_numpy(A[16:]), m)),
            _np(jcov.regularize_covariances(jnp.asarray(A[16:]), m)),
            atol=1e-4, rtol=1e-4, err_msg=m,
        )
