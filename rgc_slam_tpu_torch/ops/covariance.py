"""Per-point covariance estimation on organized scans: the port of
``rgc_slam_tpu/ops/covariance.py``: ``eigh3x3``, the regularizers,
``scan_covariances`` and ``rbf_covariances``.

Covariances are two-pass (centred) moments, and ``eigh3x3`` keeps the JAX
package's ``p`` floor so ``inv_p**3`` cannot overflow on near-zero
matrices.
"""
from __future__ import annotations

import math

import torch

from ..config import SlamConfig
from ..utils.cloud import segment_count
from ..utils.math3d import cross


def eigh3x3(A: torch.Tensor):
    """Batched symmetric 3x3 eigendecomposition (ascending eigenvalues):
    trigonometric closed form, eigenvectors by cross-product null spaces."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-24))
    inv_p = 1.0 / p
    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    detB = (b00 * c00 - a01 * c01 + a02 * c02) * (inv_p * inv_p * inv_p)
    rr = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(rr) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)                        # largest
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e2 = 3.0 * q - e1 - e3
    evals = torch.stack([e3, e2, e1], -1)

    def eigvec(lam):
        r0 = torch.stack([a00 - lam, a01, a02], -1)
        r1 = torch.stack([a01, a11 - lam, a12], -1)
        r2 = torch.stack([a02, a12, a22 - lam], -1)
        c01_ = cross(r0, r1)
        c02_ = cross(r0, r2)
        c12_ = cross(r1, r2)
        n01 = (c01_ * c01_).sum(-1, keepdim=True)
        n02 = (c02_ * c02_).sum(-1, keepdim=True)
        n12 = (c12_ * c12_).sum(-1, keepdim=True)
        best = torch.where((n01 >= n02) & (n01 >= n12), c01_,
                           torch.where(n02 >= n12, c02_, c12_))
        nrm = torch.sqrt(torch.clamp((best * best).sum(-1, keepdim=True), min=1e-30))
        return best / nrm

    v0 = eigvec(evals[..., 0])
    v2 = eigvec(evals[..., 2])
    v1 = cross(v2, v0)
    iso = (p2 < 1e-18)[..., None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    v0 = torch.where(iso, eye[0], v0)
    v1 = torch.where(iso, eye[1], v1)
    v2 = torch.where(iso, eye[2], v2)
    return evals, torch.stack([v0, v1, v2], -1)


def _recompose(V: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """V diag(vals) V^T, batched."""
    return torch.einsum("...ik,...k,...jk->...ij", V, vals, V)


def plane_regularize(cov: torch.Tensor) -> torch.Tensor:
    """Eigenvalues -> (1e-3, 1, 1), eigenvectors kept (fast_gicp PLANE)."""
    _, V = eigh3x3(cov)
    vals = torch.tensor([1e-3, 1.0, 1.0], dtype=cov.dtype, device=cov.device)
    return _recompose(V, vals.expand(V.shape[:-1]))


def norm_min_eig_regularize(cov: torch.Tensor, floor: float = 1e-3) -> torch.Tensor:
    evals, V = eigh3x3(cov)
    vals = torch.clamp(evals / torch.clamp(evals[..., 2:3], min=1e-12), min=floor)
    return _recompose(V, vals)


def min_eig_regularize(cov: torch.Tensor, floor: float = 1e-3) -> torch.Tensor:
    evals, V = eigh3x3(cov)
    return _recompose(V, torch.clamp(evals, min=floor))


def frobenius_regularize(cov: torch.Tensor, lam: float = 1e-3) -> torch.Tensor:
    C = cov + lam * torch.eye(3, dtype=cov.dtype, device=cov.device)
    # inv_ex: a singular or non-finite C gives inf / NaN entries, as
    # jnp.linalg.inv does, instead of raising
    C_inv = torch.linalg.inv_ex(C).inverse
    nrm = torch.sqrt((C_inv * C_inv).sum((-2, -1), keepdim=True))
    return torch.linalg.inv_ex(C_inv / torch.clamp(nrm, min=1e-30)).inverse


def regularize_covariances(cov: torch.Tensor, method: str) -> torch.Tensor:
    if method == "plane":
        return plane_regularize(cov)
    if method == "min_eig":
        return min_eig_regularize(cov)
    if method == "norm_min_eig":
        return norm_min_eig_regularize(cov)
    if method == "frobenius":
        return frobenius_regularize(cov)
    if method == "none":
        return cov
    raise ValueError(f"unknown cov_regularization {method!r}")


def _rows(a: torch.Tensor, row_start: int, per: int) -> torch.Tensor:
    """Rows [row_start, row_start + per) of ``a`` (all of it when per is
    its length); the start is clamped as ``lax.dynamic_slice`` clamps it."""
    n = a.shape[0]
    if per == n:
        return a
    start = min(max(int(row_start), 0), n - per)
    return a[start:start + per]


def rbf_covariances(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    kernel_width: float = 0.25,
    max_dist: float = 3.0,
    method: str = "plane",
    row_chunk: int = 2048,
    row_start: int = 0,
    row_count: "int | None" = None,
) -> torch.Tensor:
    """Gaussian-kernel covariances (covariance_estimation_rbf.cu): per
    query row, moments over every unmasked point within ``max_dist`` with
    weight exp(-kernel_width * d²), mean = Σwx/Σw, cov = Σw·xxᵀ/Σw − mean
    meanᵀ, then ``regularize_covariances``.  Masked rows get the identity
    before the regularizer.

    As in the JAX function the moments are taken around the cloud
    centroid (covariance is translation-invariant; the reference's
    one-pass E[xx]−mmᵀ cancels ~1e-4 at 40 m in float32), and each chunk
    of ``row_chunk`` query rows is one [chunk, N] Gram-identity distance
    product and one W @ [1 | x | xxᵀ] moment product: plain float32
    matmuls at the package's "highest" precision (the Gram identity needs
    it), a Python loop over the static chunks.  ``row_start`` /
    ``row_count`` restrict the query rows to one block (sp feature
    sharding); the keys stay the whole cloud, so a block equals the same
    rows of the full result.  Returns [row_count or N, 3, 3]."""
    n = xyz.shape[0]
    per = n if row_count is None else row_count
    dtype, dev = xyz.dtype, xyz.device
    m = mask.to(dtype)
    centroid = (xyz * m[:, None]).sum(0) / torch.clamp(m.sum(), min=1.0)
    x = (xyz - centroid) * m[:, None]
    sq = (x * x).sum(-1)
    xx = torch.einsum("ni,nj->nij", x, x).reshape(n, 9)
    feats = torch.cat([torch.ones((n, 1), dtype=dtype, device=dev), x, xx], 1)   # [N, 13]
    max_d2 = max_dist * max_dist
    xq, sqq = _rows(x, row_start, per), _rows(sq, row_start, per)
    moments = []
    for c0 in range(0, per, row_chunk):
        xc, sc = xq[c0:c0 + row_chunk], sqq[c0:c0 + row_chunk]
        d2 = sc[:, None] + sq[None, :] - 2.0 * (xc @ x.T)
        w = torch.where((d2 <= max_d2) & mask[None, :], torch.exp(-kernel_width * d2),
                        torch.zeros((), dtype=dtype, device=dev))
        moments.append(w @ feats)                                   # [chunk, 13]
    moments = torch.cat(moments, 0)
    sw = torch.clamp(moments[:, 0], min=1e-12)
    mean = moments[:, 1:4] / sw[:, None]
    E = moments[:, 4:].reshape(per, 3, 3) / sw[:, None, None]
    cov = E - torch.einsum("ni,nj->nij", mean, mean)
    eye = torch.eye(3, dtype=dtype, device=dev)
    cov = torch.where(_rows(mask, row_start, per)[:, None, None], cov, eye)
    return regularize_covariances(cov + 1e-6 * eye, method)


def scan_covariances(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    ring: torch.Tensor,
    pos_in_ring: torch.Tensor,
    count_of_ring: torch.Tensor,
    cfg: SlamConfig,
    row_start: int = 0,
    row_count: "int | None" = None,
) -> torch.Tensor:
    """Per-point regularized covariances on the organized cloud from a
    static neighbour gather: ±4 in-ring, plus ±2 around the azimuth-matched
    position on ring-1 and ring+1.  Returns [row_count or N, 3, 3] for the
    query rows [row_start, row_start + row_count); the gather operands stay
    the whole cloud, so a block equals the same rows of the full result."""
    n = xyz.shape[0]
    per = n if row_count is None else row_count
    dev = xyz.device
    idx = _rows(torch.arange(n, device=dev), row_start, per)
    mask_r, ring_r = _rows(mask, row_start, per), _rows(ring, row_start, per)
    pos_r, count_r = _rows(pos_in_ring, row_start, per), _rows(count_of_ring, row_start, per)
    frac = torch.where(
        count_r > 0,
        pos_r.to(xyz.dtype) / torch.clamp(count_r, min=1),
        torch.zeros((), dtype=xyz.dtype, device=dev),
    )
    counts = segment_count(torch.where(mask, ring, torch.full_like(ring, cfg.n_scans)), cfg.n_scans)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1].to(torch.int32)])

    gather_idx, gather_ok = [], []
    for o in range(-4, 5):
        ok = mask_r & (pos_r + o >= 0) & (pos_r + o < count_r)
        gather_idx.append(torch.clamp(idx + o, 0, n - 1))
        gather_ok.append(ok)
    for dr in (-1, 1):
        r2 = ring_r + dr
        ok_ring = (r2 >= 0) & (r2 < cfg.n_scans) & mask_r
        r2c = torch.clamp(r2, 0, cfg.n_scans - 1).long()
        base = starts[r2c] + (frac * counts[r2c].to(xyz.dtype)).to(torch.int32)
        for o in range(-2, 3):
            j = base + o
            pos2 = j - starts[r2c]
            ok = ok_ring & (pos2 >= 0) & (pos2 < counts[r2c])
            gather_idx.append(torch.clamp(j, 0, n - 1))
            gather_ok.append(ok)

    J = torch.stack(gather_idx, 1).long()      # [per, K]
    OK = torch.stack(gather_ok, 1) & mask[J]
    P = xyz[J]                                 # [per, K, 3]
    w = OK.to(xyz.dtype)
    wsum = torch.clamp(w.sum(1), min=1.0)
    mean = (P * w[..., None]).sum(1) / wsum[:, None]
    d = (P - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", d, d) / wsum[:, None, None]
    cov = cov + 1e-6 * torch.eye(3, dtype=xyz.dtype, device=dev)
    return regularize_covariances(cov, cfg.cov_regularization)
