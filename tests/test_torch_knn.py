"""ops/knn of the port against JAX ``ops/knn.knn`` (its XLA path on the CPU).

Indices must be equal; distances within 1e-4 absolute (float32
|q|²+|p|²−2q·p with different summation order).  The CUDA kernel itself
is tested on the card by tests/test_torch_knn_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.ops import knn as jknn
from rgc_slam_tpu_torch.ops import knn as tknn
from rgc_slam_tpu_torch.ops.cuda import knn as knn_cuda

torch.set_num_threads(1)


def _both(q, p, m, k):
    jd, ji = jknn.knn(jnp.asarray(q), jnp.asarray(p), jnp.asarray(m), k)
    td, ti = tknn.knn(torch.from_numpy(q), torch.from_numpy(p), torch.from_numpy(m), k)
    return np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()


@pytest.mark.parametrize("Q,N,K", [(200, 512, 5), (64, 256, 1), (130, 384, 3),
                                   (128, 8192, 5), (96, 5000, 4), (100, 640, 20)])
def test_plain_matches_jax(rng, Q, N, K):
    q = rng.uniform(-10, 10, (Q, 3)).astype(np.float32)
    p = rng.uniform(-10, 10, (N, 3)).astype(np.float32)
    m = rng.random(N) > 0.1
    jd, ji, td, ti = _both(q, p, m, K)
    assert ti.dtype == np.int32 and td.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, atol=1e-4, rtol=0)


def test_map_scale_coordinates(rng):
    """Centring keeps the cancellation well-conditioned 40 m from the origin."""
    off = np.array([40.0, -25.0, 1.0])
    q = (rng.uniform(-15, 15, (256, 3)) + off).astype(np.float32)
    p = (rng.uniform(-20, 20, (4096, 3)) + off).astype(np.float32)
    m = rng.random(4096) > 0.05
    jd, ji, td, ti = _both(q, p, m, 5)
    np.testing.assert_array_equal(ti, ji)
    # 4 float32 ulps of the centred squared-norm scale: |q|^2 + |p|^2 ~ 1500
    # m^2 here, where one ulp already exceeds the 1e-4 of the +-10 m cases
    c = q.mean(0)
    scale = ((q - c) ** 2).sum(1).max() + ((p - c) ** 2).sum(1).max()
    np.testing.assert_allclose(td, jd, atol=4 * np.finfo(np.float32).eps * scale, rtol=0)


def test_all_masked_and_too_few_points(rng):
    """Unfilled slots hold +inf and the lowest-index masked columns (XLA
    top_k order), so every index is in range."""
    q = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    p = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    for m in (np.zeros(128, bool), np.eye(1, 128, 7, dtype=bool)[0]):
        jd, ji, td, ti = _both(q, p, m, 5)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
        assert ((ti >= 0) & (ti < 128)).all()
    assert (ti[:, 1:] == np.array([0, 1, 2, 3])).all()


def test_duplicate_points_exact_ties(rng):
    """Integer-grid duplicates: every distance is exact in float32, so the
    tie order (lower index first) decides alone."""
    p = rng.integers(-4, 5, (600, 3)).astype(np.float32)
    p[300:] = p[:300]
    q = rng.integers(-4, 5, (63, 3)).astype(np.float32)
    q = np.concatenate([q, -q.sum(0, keepdims=True)]).astype(np.float32)  # mean 0
    m = np.ones(600, bool)
    jd, ji, td, ti = _both(q, p, m, 8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def test_dispatch_cpu_and_wrapper_guards():
    q = torch.zeros(4, 3)
    p = torch.arange(90, dtype=torch.float32).reshape(30, 3)
    m = torch.ones(30, dtype=torch.bool)
    d, i = tknn.knn(q, p, m, 25)       # k > 24 is fine on the CPU (plain path)
    assert d.shape == (4, 25) and i.dtype == torch.int32
    launches = knn_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        knn_cuda.knn(q, p, m, 5)       # the kernel wrapper never takes CPU tensors
    assert knn_cuda.launches == launches
