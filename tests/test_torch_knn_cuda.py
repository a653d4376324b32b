"""The Hopper kNN kernel (csrc/knn.cu) against ``knn_plain`` on the card.

Needs a CUDA device and nvcc; every test is marked ``gpu`` and skips
without a device (decided in a fixture, at run time).  This file imports
neither jax nor the repository's conftest fixtures, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_knn_cuda.py
"""
import numpy as np
import pytest
import torch

from rgc_slam_tpu_torch.ops import knn as knn_ops
from rgc_slam_tpu_torch.ops.cuda import knn as knn_cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _inputs(dev, Q, N, seed, keep=0.9, offset=0.0):
    g = np.random.default_rng(seed)
    q = torch.from_numpy((g.uniform(-10, 10, (Q, 3)) + offset).astype(np.float32)).to(dev)
    p = torch.from_numpy((g.uniform(-10, 10, (N, 3)) + offset).astype(np.float32)).to(dev)
    m = torch.from_numpy(g.random(N) < keep).to(dev)
    return q, p, m


SHAPES = [(512, 8192, 5), (2048, 32768, 5), (64, 256, 1), (130, 384, 3), (96, 5000, 4),
          (100, 640, 20), (33, 700, 24)]


def _assert_matches_plain(q, p, m, K):
    """Distances to 1e-5 x the squared-coordinate scale; indices equal
    except at near-ties, where the kernel's point must be as near in f64."""
    d_k, i_k = knn_cuda.knn(q, p, m, K)
    d_p, i_p = knn_ops.knn_plain(q, p, m, K)
    torch.cuda.synchronize()
    c = q.mean(0)
    qc, pc = (q - c).double(), (p - c).double()
    tol = 1e-5 * float((qc * qc).sum(-1).max() + (pc * pc).sum(-1).max())
    assert float((d_k - d_p).abs().max()) <= tol
    bad = i_k != i_p
    if bool(bad.any()):
        rows = bad.nonzero()[:, 0]
        d_true = ((qc[rows] - pc[i_k[bad].long()]) ** 2).sum(-1)
        assert float((d_true - d_p[bad].double()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("Q,N,K", SHAPES)
def test_kernel_matches_plain(cuda, Q, N, K):
    _assert_matches_plain(*_inputs(cuda, Q, N, seed=Q + N + K, offset=30.0), K)


@pytest.mark.gpu
@pytest.mark.parametrize("search", ["loop ICP 2560x16384 k=1", "self 16384x16384 k=20"])
def test_loop_closure_shapes(cuda, search):
    """The loop closure's searches: the keyframe cloud's 1-NN in the
    voxelized submap, and the GICP / normals self-search of the submap
    (10% of the points masked).  Kernel against plain, then one chunk, the
    planned split and a ragged split bit-identical."""
    if search.startswith("loop"):
        q, p, m = _inputs(cuda, 2560, 16384, seed=21)
        K = 1
    else:
        _, p, m = _inputs(cuda, 1, 16384, seed=22)
        q, K = p, 20
    _assert_matches_plain(q, p, m, K)
    plan = knn_cuda.split_plan(q.shape[0], p.shape[0], K,
                               torch.cuda.get_device_properties(cuda).multi_processor_count)
    d1, i1 = knn_cuda.knn(q, p, m, K, chunks=1)
    for chunks in (plan.chunks, _ragged_chunks(p.shape[0])):
        d, i = knn_cuda.knn(q, p, m, K, chunks=chunks)
        assert torch.equal(d, d1) and torch.equal(i, i1), (chunks, plan)


@pytest.mark.gpu
def test_exact_ties_and_masks(cuda):
    g = np.random.default_rng(1)
    p = g.integers(-8, 9, (3000, 3)).astype(np.float32)
    p[1500:] = p[:1500]
    q = g.integers(-8, 9, (255, 3)).astype(np.float32)
    q = np.concatenate([q, -q.sum(0, keepdims=True)]).astype(np.float32)
    q, p = torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda)
    for m in (torch.ones(3000, dtype=torch.bool, device=cuda),
              torch.zeros(3000, dtype=torch.bool, device=cuda),
              torch.arange(3000, device=cuda) % 997 == 3):
        d_k, i_k = knn_cuda.knn(q, p, m, 8)
        d_p, i_p = knn_ops.knn_plain(q, p, m, 8)
        assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)


@pytest.mark.gpu
def test_dispatch_counts_and_guards(cuda):
    q, p, m = _inputs(cuda, 50, 300, seed=3)
    before = knn_cuda.launches
    knn_ops.knn(q, p, m, 5)
    assert knn_cuda.launches == before + 1
    with pytest.raises(ValueError):
        knn_ops.knn(q, p, m, 25)
    with pytest.raises(TypeError):
        knn_cuda.knn(q.double(), p, m, 5)
    with pytest.raises(ValueError):
        knn_cuda.knn(q, p[:, :2].contiguous(), m, 5)
    for bad in (0, 301, 299):           # 299 chunks of ceil(300/299) = 2 points leave some empty
        with pytest.raises(ValueError):
            knn_cuda.knn(q, p, m, 5, chunks=bad)
    with pytest.raises(ValueError):     # lanes of points must match the queries' lanes
        knn_cuda.knn(q[None].expand(2, -1, -1), p[None], m[None], 5)
    assert knn_cuda.launches == before + 1
    knn_cuda.reset_counts()
    knn_ops.knn(q, p, m, 5)             # two launches (chunks + merge) count once
    knn_cuda.knn(q, p, m, 5, chunks=3)
    knn_cuda.knn(q[:7].contiguous(), p, m, 1)
    assert knn_cuda.launches == 3
    assert dict(knn_cuda.launches_by_shape) == {(1, 50, 300, 5): 2, (1, 7, 300, 1): 1}


def _ragged_chunks(n):
    """A split whose last chunk is shorter than the others."""
    for s in (7, 5, 3, 6, 9, 11, 13):
        chunk = -(-n // s)
        if n % chunk and (s - 1) * chunk < n:
            return s
    raise AssertionError(n)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 5, 20, 24])
@pytest.mark.parametrize("Q,N", sorted({(q, n) for q, n, _ in SHAPES}))
def test_split_invariance(cuda, Q, N, K):
    """One chunk, the planned split and a ragged split: bit-identical."""
    q, p, m = _inputs(cuda, Q, N, seed=Q * N + K, offset=30.0)
    props = torch.cuda.get_device_properties(cuda)
    plan = knn_cuda.split_plan(Q, N, K, props.multi_processor_count)
    d1, i1 = knn_cuda.knn(q, p, m, K, chunks=1)
    for chunks in (None, plan.chunks, _ragged_chunks(N)):
        d, i = knn_cuda.knn(q, p, m, K, chunks=chunks)
        assert torch.equal(d, d1) and torch.equal(i, i1), (chunks, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("chunks", [2, 3, 7, 40])     # 40: a merge lane holds 2 lists
def test_exact_ties_across_chunks(cuda, chunks):
    """Duplicates half the cloud apart fall in other chunks; the lower
    index wins every tie, as in the plain version."""
    g = np.random.default_rng(2)
    p = g.integers(-4, 5, (1400, 3)).astype(np.float32)
    p[700:] = p[:700]
    q = g.integers(-4, 5, (199, 3)).astype(np.float32)
    q = np.concatenate([q, -q.sum(0, keepdims=True)]).astype(np.float32)
    q, p = torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda)
    for m in (torch.ones(1400, dtype=torch.bool, device=cuda),
              torch.arange(1400, device=cuda) % 5 != 2):
        for k in (1, 8, 24):
            d_k, i_k = knn_cuda.knn(q, p, m, k, chunks=chunks)
            d_p, i_p = knn_ops.knn_plain(q, p, m, k)
            assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p), (k, chunks)


def nan_cases(dev):
    """Integer-valued inputs (every distance exact in float32, the query
    mean 0) with NaN coordinates: NaN in masked points, in unmasked points,
    in one query (the centre, and so every unmasked distance, NaN: 8 masked
    points come first, then NaN), and fewer finite unmasked points than k.  Returns {name: (q, p, m, k)}."""
    g = np.random.default_rng(4)
    p = g.integers(-6, 7, (3000, 3)).astype(np.float32)
    q = g.integers(-6, 7, (199, 3)).astype(np.float32)
    q = np.concatenate([q, -q.sum(0, keepdims=True)]).astype(np.float32)
    m = g.random(3000) > 0.2
    masked_nan = np.where(m[:, None], p, np.nan).astype(np.float32)
    unmasked_nan = p.copy()
    unmasked_nan[np.flatnonzero(m)[::7], 1] = np.nan
    nan_query = q.copy()
    nan_query[5, 2] = np.nan
    few = np.zeros(3000, bool)
    few[[3, 1500, 1501, 2990]] = True
    few_nan = p.copy()
    few_nan[1500] = np.nan
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"masked points": (t(q), t(masked_nan), t(m), 5),
            "unmasked points": (t(q), t(unmasked_nan), t(m), 8),
            "a query": (t(nan_query), t(p), t(np.arange(3000) % 375 != 7), 20),   # 8 masked
            "fewer finite than k": (t(q), t(few_nan), t(few), 6)}


def same_bits(d_k, i_k, d_p, i_p) -> bool:
    """Indices equal, NaN in the same places, every other distance equal."""
    return (torch.equal(i_k, i_p) and torch.equal(torch.isnan(d_k), torch.isnan(d_p))
            and torch.equal(torch.nan_to_num(d_k), torch.nan_to_num(d_p)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["masked points", "unmasked points", "a query",
                                  "fewer finite than k"])
def test_nan_semantics_match_plain(cuda, case):
    """knn_plain's NaN semantics (JAX's, tests/test_torch_knn.py) bit for
    bit, at one chunk, the planned split and a ragged split, one lane and a
    batch of three; every index in [0, N)."""
    q, p, m, k = nan_cases(cuda)[case]
    d_p, i_p = knn_ops.knn_plain(q, p, m, k)
    for chunks in (1, None, _ragged_chunks(p.shape[0])):
        d_k, i_k = knn_cuda.knn(q, p, m, k, chunks=chunks)
        torch.cuda.synchronize()
        assert same_bits(d_k, i_k, d_p, i_p), (case, chunks)
        assert bool(((i_k >= 0) & (i_k < p.shape[0])).all())
    d_b, i_b = knn_cuda.knn(*(torch.stack([x] * 3) for x in (q, p, m)), k)
    assert all(same_bits(d_b[b], i_b[b], d_p, i_p) for b in range(3))
    if case == "a query":
        assert bool(torch.isnan(d_p).any()) and bool(torch.isinf(d_p).any())


# --- the batched launch (a robot fleet: B searches of one shape) ---

FLEET_SHAPES = [(256, 2048, 5), (1024, 8192, 5), (1280, 4096, 1), (33, 700, 24)]


def _lanes(dev, B, Q, N, seed):
    """B lanes with ragged masks: lane b keeps a different share of points."""
    g = np.random.default_rng(seed)
    q = torch.from_numpy((g.uniform(-10, 10, (B, Q, 3)) + 30.0).astype(np.float32)).to(dev)
    p = torch.from_numpy((g.uniform(-12, 12, (B, N, 3)) + 30.0).astype(np.float32)).to(dev)
    keep = np.linspace(0.3, 1.0, B)[:, None] if B > 1 else np.ones((1, 1))
    m = torch.from_numpy(g.random((B, N)) < keep).to(dev)
    return q, p, m


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("Q,N,K", FLEET_SHAPES)
def test_batched_launch_equals_lane_launches(cuda, B, Q, N, K):
    """One launch for B lanes: bit-identical to B launches of one lane each,
    at the planned split and at one chunk; within tolerance of the batched
    plain version."""
    q, p, m = _lanes(cuda, B, Q, N, seed=B * Q + N + K)
    knn_cuda.reset_counts()
    d, i = knn_cuda.knn(q, p, m, K)
    assert knn_cuda.launches == 1 and dict(knn_cuda.launches_by_shape) == {(B, Q, N, K): 1}
    assert d.shape == i.shape == (B, Q, K)
    d1, i1 = knn_cuda.knn(q, p, m, K, chunks=1)
    assert torch.equal(d, d1) and torch.equal(i, i1)
    for b in range(B):
        db, ib = knn_cuda.knn(q[b], p[b], m[b], K)
        assert torch.equal(d[b], db) and torch.equal(i[b], ib), b
        _assert_matches_plain(q[b], p[b], m[b], K)
    d_p, _ = knn_ops.knn_plain(q, p, m, K)             # the batched plain version
    c = q.mean(1, keepdim=True)
    qc, pc = (q - c).double(), (p - c).double()
    tol = 1e-5 * float((qc * qc).sum(-1).max() + (pc * pc).sum(-1).max())
    fin = torch.isfinite(d_p)
    assert torch.equal(torch.isfinite(d), fin) and float((d - d_p)[fin].abs().max()) <= tol


@pytest.mark.gpu
def test_shared_points_lane_stride_zero(cuda):
    """A points operand expanded over the lanes (stride 0) is read, not
    copied: the result equals that of materialized lanes."""
    q, p, m = _lanes(cuda, 4, 200, 3000, seed=9)
    pe, me = p[:1].expand(4, -1, -1), m[:1].expand(4, -1)
    d, i = knn_cuda.knn(q, pe, me, 5)
    d_c, i_c = knn_cuda.knn(q, pe.contiguous(), me.contiguous(), 5)
    assert torch.equal(d, d_c) and torch.equal(i, i_c)


@pytest.mark.gpu
def test_vmapped_knn_is_one_launch(cuda):
    """``torch.func.vmap`` of ``ops.knn.knn`` (the fleet's call) reaches the
    kernel once for every lane, nested vmaps and an unbatched points operand
    included, with the per-lane results."""
    q, p, m = _lanes(cuda, 6, 300, 4000, seed=4)
    knn_cuda.reset_counts()
    d, i = torch.func.vmap(knn_ops.knn, in_dims=(0, None, None, None))(q, p[0], m[0], 5)
    assert knn_cuda.launches == 1 and dict(knn_cuda.launches_by_shape) == {(6, 300, 4000, 5): 1}
    qq = q.reshape(2, 3, 300, 3)
    inner = torch.func.vmap(knn_ops.knn, in_dims=(0, None, None, None))
    d2, i2 = torch.func.vmap(inner, in_dims=(0, None, None, None))(qq, p[0], m[0], 5)
    assert knn_cuda.launches == 2
    assert torch.equal(d2.reshape(6, 300, 5), d) and torch.equal(i2.reshape(6, 300, 5), i)
    for b in range(6):
        db, ib = knn_cuda.knn(q[b], p[0], m[0], 5)
        assert torch.equal(d[b], db) and torch.equal(i[b], ib), b
