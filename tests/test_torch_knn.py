"""ops/knn of the port against JAX ``ops/knn.knn`` (its XLA path on the CPU).

Indices must be equal; distances within 1e-4 absolute (float32
|q|²+|p|²−2q·p with different summation order).  The operator under
``torch.func.vmap`` (the fleet's call) must equal the per-lane plain
version exactly.  The CUDA kernel itself is tested on the card by
tests/test_torch_knn_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.func import vmap

from rgc_slam_tpu.ops import knn as jknn
from rgc_slam_tpu_torch.ops import knn as tknn
from rgc_slam_tpu_torch.ops.cuda import knn as knn_cuda
from rgc_slam_tpu_torch.utils.lanes import strict_vmap

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


def _nan_cases(rng):
    """Integer-valued inputs (exact distances) with NaN coordinates."""
    q = rng.integers(-6, 7, (24, 3)).astype(np.float32)
    p = rng.integers(-6, 7, (300, 3)).astype(np.float32)
    m = rng.random(300) > 0.2
    masked_nan = p.copy()
    masked_nan[~m] = np.nan
    unmasked_nan = p.copy()
    unmasked_nan[np.flatnonzero(m)[::7], 1] = np.nan
    nan_query = q.copy()
    nan_query[5, 2] = np.nan
    few = np.zeros(300, bool)
    few[[3, 40, 41, 250]] = True
    few_nan = p.copy()
    few_nan[40] = np.nan
    return {
        "masked points": (q, masked_nan, m, 5),
        "unmasked points": (q, unmasked_nan, m, 5),
        "a query": (nan_query, p, m, 5),
        "fewer finite than k": (q, few_nan, few, 6),
    }


@pytest.mark.parametrize("case", ["masked points", "unmasked points", "a query",
                                  "fewer finite than k"])
def test_plain_nan_semantics_match_jax(rng, case):
    """The NaN spec, JAX's ops/knn.knn on the CPU: a masked point is +inf
    whatever its coordinates; a NaN distance (a NaN point, or every point
    once a NaN query has made the search's centre NaN) ranks after +inf,
    ties to the lower index; distances keep NaN through the clamp; every
    index lies in [0, N)."""
    q, p, m, k = _nan_cases(rng)[case]
    jd, ji, td, ti = _both(q, p, m, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(np.isnan(td), np.isnan(jd))
    np.testing.assert_array_equal(td, jd)          # NaN in the same places, else equal
    assert ((ti >= 0) & (ti < p.shape[0])).all()
    if case == "a query":                          # the masked points first, at +inf
        assert np.isinf(td).all() and not m[ti].any()


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
    launches, by_shape = knn_cuda.launches, knn_cuda.launches_by_shape.copy()
    with pytest.raises(ValueError, match="CUDA"):
        knn_cuda.knn(q, p, m, 5)       # the kernel wrapper never takes CPU tensors
    assert knn_cuda.launches == launches and knn_cuda.launches_by_shape == by_shape


def _lanes(rng, B, Q, N):
    q = rng.uniform(-10, 10, (B, Q, 3)).astype(np.float32)
    p = rng.uniform(-10, 10, (B, N, 3)).astype(np.float32)
    m = rng.random((B, N)) < np.linspace(0.2, 0.95, B)[:, None]     # ragged per lane
    return torch.from_numpy(q), torch.from_numpy(p), torch.from_numpy(m)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("B,Q,N,K", [(3, 64, 500, 5), (4, 17, 90, 1), (2, 40, 300, 20)])
def test_vmapped_knn_equals_lanes(rng, B, Q, N, K, shared):
    """vmap(knn) on the CPU: exactly the stacked per-lane ``knn_plain``,
    with the points (and mask) either per lane or one unbatched operand."""
    q, p, m = _lanes(rng, B, Q, N)
    in_dims = (0, None, None, None) if shared else (0, 0, 0, None)
    pp, mm = (p[0], m[0]) if shared else (p, m)
    with strict_vmap():
        d, i = vmap(tknn.knn, in_dims=in_dims)(q, pp, mm, K)
    assert d.shape == i.shape == (B, Q, K) and i.dtype == torch.int32
    for b in range(B):
        d1, i1 = tknn.knn_plain(q[b], p[0] if shared else p[b], m[0] if shared else m[b], K)
        assert torch.equal(d[b], d1) and torch.equal(i[b], i1), b


def test_nested_vmap_knn(rng):
    """Two vmap levels fold into one batch of the operator."""
    q, p, m = _lanes(rng, 6, 30, 200)
    inner = vmap(tknn.knn, in_dims=(0, 0, 0, None))
    with strict_vmap():
        d, i = vmap(inner, in_dims=(0, 0, 0, None))(
            q.reshape(2, 3, 30, 3), p.reshape(2, 3, 200, 3), m.reshape(2, 3, 200), 5)
    db, ib = tknn.knn_batched(q, p, m, 5)
    assert torch.equal(d.reshape(6, 30, 5), db) and torch.equal(i.reshape(6, 30, 5), ib)


def test_batched_plain_equals_lanes(rng):
    q, p, m = _lanes(rng, 5, 50, 400)
    d, i = tknn.knn_plain(q, p, m, 7)
    for b in range(5):
        d1, i1 = tknn.knn_plain(q[b], p[b], m[b], 7)
        assert torch.equal(d[b], d1) and torch.equal(i[b], i1)


def test_reset_counts():
    knn_cuda.launches += 2
    knn_cuda.launches_by_shape[(1, 4, 30, 5)] += 2
    knn_cuda.reset_counts()
    assert knn_cuda.launches == 0 and not knn_cuda.launches_by_shape


# --- the split of the point axis (csrc/knn.cu: chunk kernel + merge) ---

SHAPES = [(2048, 32768, 5), (512, 8192, 5), (2048, 32768, 20), (2048, 32768, 1),
          (16384, 16384, 20), (64, 256, 1), (33, 700, 24), (96, 5000, 4), (1, 1, 1), (7, 23, 5)]


@pytest.mark.parametrize("nq,n,k", SHAPES)
@pytest.mark.parametrize("num_sms", [132, 8])
@pytest.mark.parametrize("lanes", [1, 128])
def test_split_plan_covers_the_points(nq, n, k, num_sms, lanes):
    plan = knn_cuda.split_plan(nq, n, k, num_sms, lanes=lanes)
    assert plan.threads in (32, 64, 128)
    assert 1 <= plan.chunks <= knn_cuda.MAX_CHUNKS
    # contiguous chunks [s * chunk, (s + 1) * chunk) cut at n: all non-empty, union [0, n)
    assert plan.chunks * plan.chunk >= n > (plan.chunks - 1) * plan.chunk
    assert plan.chunks == 1 or plan.chunk >= knn_cuda.MIN_CHUNK


def test_split_plan_fills_the_card():
    for nq, n, k in [(2048, 32768, 5), (512, 8192, 5)]:     # surf, corner (mapping.py)
        plan = knn_cuda.split_plan(nq, n, k, 132)
        assert plan.blocks(nq) >= 2 * 132, plan
        assert plan.chunks > 1
    for nq, n, k in [(64, 200, 1), (100, 100, 5), (4096, 255, 24)]:   # tiny N: one chunk
        assert knn_cuda.split_plan(nq, n, k, 132).chunks == 1


def test_split_plan_counts_the_lanes():
    """A fleet's lanes fill the card with query warps: at FLEET_CONFIG's
    surf shape 128 x 1024 queries need no split of the points."""
    assert knn_cuda.split_plan(1024, 8192, 5, 132, lanes=128).chunks == 1
    assert knn_cuda.split_plan(1024, 8192, 5, 132, lanes=1).chunks > 1
    corner = knn_cuda.split_plan(256, 2048, 5, 132, lanes=128)
    assert corner.blocks(256, 128) >= 2 * 132
    with pytest.raises(ValueError):
        knn_cuda.split_plan(10, 100, 5, 132, lanes=0)


def test_split_plan_forced_chunks():
    assert knn_cuda.split_plan(100, 50, 5, 132, chunks=7) == knn_cuda.SplitPlan(32, 7, 8)
    assert knn_cuda.split_plan(100, 50, 5, 132, chunks=1).chunk == 50
    for bad in (0, 51, 10 ** 6):
        with pytest.raises(ValueError):
            knn_cuda.split_plan(100, 50, 5, 132, chunks=bad)
    with pytest.raises(ValueError, match="non-empty"):
        knn_cuda.split_plan(100, 10, 5, 132, chunks=6)        # ceil(10/6) = 2: 5 chunks


_EMPTY = np.iinfo(np.int32).max        # an empty slot's index
_SENTINEL = (None, _EMPTY)


def _rank(e):
    """The kernel's key order: finite distances ascending, then +inf, then
    NaN, then empty slots; ties to the lower index."""
    d, idx = e
    if d is None:
        return (3, 0.0, idx)
    if np.isnan(d):
        return (2, 0.0, idx)
    return (1, 0.0, idx) if d == np.inf else (0, d, idx)


def _insert(lst, cand):
    """The kernel's insertion into a sorted list of k (d, idx) entries."""
    if not _rank(cand) < _rank(lst[-1]):
        return False
    lst[-1] = cand
    lst.sort(key=_rank)
    return True


def _chunk_and_merge(d2, k, chunks, lanes=32):
    """What the kernel does with a [Q, N] distance matrix (knn_plain's, so
    the arithmetic is the same).  Per chunk, the top-k on (d, idx) over its
    points in ascending index, from empty slots.  Per query, lane l of a
    warp merges the lists of chunks l, l + lanes, ... (leaving a list at its
    first entry that does not enter), then k rounds of an argmin over the
    lanes' heads emit the output; clamp last (NaN stays NaN)."""
    nq, n = d2.shape
    chunk = -(-n // chunks)
    lists = []
    for s in range(chunks):
        part = []
        for q in range(nq):
            lst = [_SENTINEL] * k
            for j in range(s * chunk, min(n, (s + 1) * chunk)):
                _insert(lst, (float(d2[q, j]), j))
            part.append(lst)
        lists.append(part)
    out_d = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int32)
    for q in range(nq):
        held = []
        for lane in range(lanes):
            best = [_SENTINEL] * k
            for s in range(lane, chunks, lanes):
                for entry in lists[s][q]:
                    if not _insert(best, entry):
                        break
            held.append(best)
        for t in range(k):
            lane = min(range(lanes), key=lambda l: _rank(held[l][0]))
            d, out_i[q, t] = held[lane][0]
            out_d[q, t] = np.inf if d is None else (0.0 if d < 0 else d)
            held[lane] = held[lane][1:] + [_SENTINEL]
    return out_d, out_i


def _split_cases(rng):
    grid = rng.integers(-3, 4, (60, 3)).astype(np.float32)
    grid[30:] = grid[:30]                       # duplicates 30 apart: other chunks
    q_grid = rng.integers(-3, 4, (11, 3)).astype(np.float32)
    q_grid = np.concatenate([q_grid, -q_grid.sum(0, keepdims=True)]).astype(np.float32)
    few = rng.random(40) < 0.1
    few[:2] = [True, False]
    return {
        "ragged": (rng.uniform(-5, 5, (13, 3)), rng.uniform(-5, 5, (50, 3)), rng.random(50) > 0.1, 5),
        "chunks shorter than k": (rng.uniform(-5, 5, (9, 3)), rng.uniform(-5, 5, (45, 3)),
                                  rng.random(45) > 0.2, 20),
        "duplicates across chunks": (q_grid, grid, np.ones(60, bool), 8),
        "all masked": (rng.uniform(-1, 1, (6, 3)), rng.uniform(-1, 1, (30, 3)), np.zeros(30, bool), 5),
        "fewer unmasked than k": (rng.uniform(-1, 1, (7, 3)), rng.uniform(-1, 1, (40, 3)), few, 6),
        "NaN points": (q_grid, np.where(np.arange(60)[:, None] % 9 == 4, np.nan, grid),
                       np.arange(60) % 5 != 0, 8),
        "NaN query": (np.where(np.arange(12)[:, None] == 3, np.nan, q_grid), grid,
                      np.arange(60) % 4 != 0, 8),
    }


@pytest.mark.parametrize("lanes", [32, 2])     # 2: a lane merges several chunks' lists
@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
@pytest.mark.parametrize("case", ["ragged", "chunks shorter than k", "duplicates across chunks",
                                  "all masked", "fewer unmasked than k", "NaN points",
                                  "NaN query"])
def test_chunk_and_merge_equals_plain(rng, case, chunks, lanes):
    q, p, m, k = _split_cases(rng)[case]
    q, p, m = (torch.from_numpy(np.ascontiguousarray(a)) for a in
               (q.astype(np.float32), p.astype(np.float32), m))
    d_p, i_p = tknn.knn_plain(q, p, m, k)
    center = q.mean(0, keepdim=True)            # knn_plain's distance matrix
    qc, pc = q - center, p - center
    d2 = (qc * qc).sum(-1, keepdim=True) + (pc * pc).sum(-1)[None, :] - 2.0 * (qc @ pc.T)
    d2 = torch.where(m[None, :], d2, torch.full_like(d2, torch.inf))
    d_s, i_s = _chunk_and_merge(d2.numpy(), k, chunks, lanes)
    np.testing.assert_array_equal(i_s, i_p.numpy())
    np.testing.assert_array_equal(d_s, d_p.numpy())        # NaN where knn_plain's is NaN
