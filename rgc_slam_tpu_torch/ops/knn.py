"""k-nearest-neighbour search for mapping association: the port of
``rgc_slam_tpu/ops/knn.py``.

``knn`` dispatches on where its tensors lie: a CUDA tensor goes to the
hand-written Hopper kernel (``ops/cuda/knn.py``, source ``csrc/knn.cu``),
a CPU tensor to ``knn_plain``.  There is no size gate and no fallback: the
kernel takes k <= 24 (the TPU kernel's gate) and raises otherwise.

Semantics (both paths): coordinates centred on the query mean, squared
distances ``|q|²+|p|²−2q·p`` in float32, masked points at +inf, ties to the
lower index, distances clamped at 0.  When fewer than k points are
unmasked, the unfilled slots hold +inf and the lowest-index masked
columns — XLA ``top_k`` semantics, so indices are always in range.
"""
from __future__ import annotations

import torch


def knn_plain(queries: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
              k: int):
    """The XLA formulation: centred float32 ``queries @ points.T`` and a
    stable sort (``torch.topk`` does not promise lower-index tie order).
    Materializes the [Q, N] distance matrix."""
    center = queries.mean(0, keepdim=True)
    qc = queries - center
    pc = points - center
    q2 = (qc * qc).sum(-1, keepdim=True)
    p2 = (pc * pc).sum(-1)
    d2 = q2 + p2[None, :] - 2.0 * (qc @ pc.T)
    d2 = torch.where(points_mask[None, :], d2, torch.full_like(d2, torch.inf))
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return torch.clamp(vals[:, :k], min=0.0), idx[:, :k].to(torch.int32)


def knn(queries: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor, k: int):
    """Returns (sq_dists [Q, k] float32, indices [Q, k] int32)."""
    if queries.is_cuda:
        from .cuda import knn as knn_cuda

        return knn_cuda.knn(queries, points, points_mask, k)
    return knn_plain(queries, points, points_mask, k)
