"""k-nearest-neighbour search for mapping association: the port of
``rgc_slam_tpu/ops/knn.py``.

``knn`` is one custom operator, ``rgc_slam::knn``, over a leading batch of
independent searches, and it dispatches on where its tensors lie: a CUDA
tensor goes to the hand-written Hopper kernel (``ops/cuda/knn.py``, source
``csrc/knn.cu``), one launch for the whole batch; a CPU tensor to
``knn_plain`` over the same batch.  There is no size gate and no fallback:
the kernel takes k <= 24 (the TPU kernel's gate) and raises otherwise.

Under ``torch.func.vmap`` (a robot fleet, ``parallel/fleet.py``) the
operator's vmap rule moves the vmapped dimension to the front, folds it
into the operator's own batch (so nested vmaps fold level by level) and
shares an unbatched operand across the lanes without a copy: every lane of
every level rides one launch, as the Pallas kernel's grid gains a batch
axis under ``jax.vmap``.

Semantics (both paths): coordinates centred on each search's query mean,
squared distances ``|q|²+|p|²−2q·p`` in float32, masked points at +inf,
ties to the lower index, distances clamped at 0.  When fewer than k points
are unmasked, the unfilled slots hold +inf and the lowest-index masked
columns — XLA ``top_k`` semantics, so indices are always in range.
"""
from __future__ import annotations

from typing import Tuple

import torch


def knn_plain(queries: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
              k: int):
    """The XLA formulation over any leading batch dimensions: centred
    float32 ``queries @ points.T`` and a stable sort (``torch.topk`` does
    not promise lower-index tie order).  Materializes the [..., Q, N]
    distance matrix."""
    center = queries.mean(-2, keepdim=True)
    qc = queries - center
    pc = points - center
    q2 = (qc * qc).sum(-1, keepdim=True)
    p2 = (pc * pc).sum(-1)
    d2 = q2 + p2[..., None, :] - 2.0 * (qc @ pc.transpose(-1, -2))
    d2 = torch.where(points_mask[..., None, :], d2, torch.full_like(d2, torch.inf))
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.clamp(vals[..., :k], min=0.0), idx[..., :k].to(torch.int32)


@torch.library.custom_op("rgc_slam::knn", mutates_args=())
def knn_batched(queries: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B searches at once: queries [B, Q, 3], points [B, N, 3], points_mask
    [B, N] -> (sq_dists [B, Q, k] float32, indices [B, Q, k] int32)."""
    if queries.is_cuda:
        from .cuda import knn as knn_cuda

        return knn_cuda.knn(queries, points, points_mask, k)
    return knn_plain(queries, points, points_mask, k)


@knn_batched.register_fake
def _knn_fake(queries, points, points_mask, k):
    shape = queries.shape[:-1] + (k,)
    return (queries.new_empty(shape), queries.new_empty(shape, dtype=torch.int32))


def _knn_vmap(info, in_dims, queries, points, points_mask, k):
    """Fold the vmapped dimension into the operator's batch: [V, B, ...] ->
    [V * B, ...], an unbatched operand expanded (not copied) to V lanes."""
    lanes = info.batch_size

    def fold(x, dim):
        x = x.movedim(dim, 0) if dim is not None else x.expand(lanes, *x.shape)
        return x.flatten(0, 1)

    q, p, m = (fold(x, d) for x, d in zip((queries, points, points_mask), in_dims[:3]))
    d2, idx = knn_batched(q.contiguous(), p if in_dims[1] is None else p.contiguous(),
                          m if in_dims[2] is None else m.contiguous(), k)
    return (d2.unflatten(0, (lanes, -1)), idx.unflatten(0, (lanes, -1))), (0, 0)


knn_batched.register_vmap(_knn_vmap)


def knn(queries: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor, k: int):
    """Returns (sq_dists [Q, k] float32, indices [Q, k] int32): one search,
    a batch of one of ``knn_batched``."""
    d2, idx = knn_batched(queries[None], points[None], points_mask[None], k)
    return d2[0], idx[0]
