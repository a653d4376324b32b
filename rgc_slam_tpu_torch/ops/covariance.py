"""Per-point covariance estimation on organized scans: the port of
``rgc_slam_tpu/ops/covariance.py`` (``eigh3x3``, the regularizers and
``scan_covariances``; ``rbf_covariances`` is not ported yet).

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
    C_inv = torch.linalg.inv(C)
    nrm = torch.sqrt((C_inv * C_inv).sum((-2, -1), keepdim=True))
    return torch.linalg.inv(C_inv / torch.clamp(nrm, min=1e-30))


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


def scan_covariances(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    ring: torch.Tensor,
    pos_in_ring: torch.Tensor,
    count_of_ring: torch.Tensor,
    cfg: SlamConfig,
) -> torch.Tensor:
    """Per-point regularized covariances on the organized cloud from a
    static neighbour gather: ±4 in-ring, plus ±2 around the azimuth-matched
    position on ring-1 and ring+1.  Returns [N, 3, 3]."""
    n = xyz.shape[0]
    dev = xyz.device
    idx = torch.arange(n, device=dev)
    frac = torch.where(
        count_of_ring > 0,
        pos_in_ring.to(xyz.dtype) / torch.clamp(count_of_ring, min=1),
        torch.zeros((), dtype=xyz.dtype, device=dev),
    )
    counts = segment_count(torch.where(mask, ring, torch.full_like(ring, cfg.n_scans)), cfg.n_scans)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1].to(torch.int32)])

    gather_idx, gather_ok = [], []
    for o in range(-4, 5):
        ok = mask & (pos_in_ring + o >= 0) & (pos_in_ring + o < count_of_ring)
        gather_idx.append(torch.clamp(idx + o, 0, n - 1))
        gather_ok.append(ok)
    for dr in (-1, 1):
        r2 = ring + dr
        ok_ring = (r2 >= 0) & (r2 < cfg.n_scans) & mask
        r2c = torch.clamp(r2, 0, cfg.n_scans - 1).long()
        base = starts[r2c] + (frac * counts[r2c].to(xyz.dtype)).to(torch.int32)
        for o in range(-2, 3):
            j = base + o
            pos2 = j - starts[r2c]
            ok = ok_ring & (pos2 >= 0) & (pos2 < counts[r2c])
            gather_idx.append(torch.clamp(j, 0, n - 1))
            gather_ok.append(ok)

    J = torch.stack(gather_idx, 1).long()      # [N, K]
    OK = torch.stack(gather_ok, 1) & mask[J]
    P = xyz[J]                                 # [N, K, 3]
    w = OK.to(xyz.dtype)
    wsum = torch.clamp(w.sum(1), min=1.0)
    mean = (P * w[..., None]).sum(1) / wsum[:, None]
    d = (P - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", d, d) / wsum[:, None, None]
    cov = cov + 1e-6 * torch.eye(3, dtype=xyz.dtype, device=dev)
    return regularize_covariances(cov, cfg.cov_regularization)
