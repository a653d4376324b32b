"""Masked point-cloud helpers: the port of ``rgc_slam_tpu/utils/cloud.py``."""
from __future__ import annotations

import torch

from . import math3d


def transform_points(q: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rigid transform of [N,3] points by pose (q, t)."""
    return math3d.quat_rotate(q[None, :], pts) + t[None, :]


def masked_centroid(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    w = mask.to(pts.dtype)
    return (pts * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1.0)


def range_filter_mask(pts: torch.Tensor, mask: torch.Tensor, min_range: float,
                      max_range: float) -> torch.Tensor:
    """Range gate + rear-cone cut (drops x<0 and |y|<0.5 behind the robot)."""
    d2 = (pts * pts).sum(-1)
    keep = (d2 > min_range**2) & (d2 < max_range**2)
    rear = (pts[..., 0] < 0) & (torch.abs(pts[..., 1]) < 0.5)
    return mask & keep & ~rear


def concat_padded(arrays, masks, out_cap: int):
    """Concatenate padded arrays along axis 0, valid entries first (stable),
    truncated or zero-padded to ``out_cap``."""
    cat = torch.cat(list(arrays), 0)
    m = torch.cat(list(masks), 0)
    order = torch.argsort((~m).to(torch.int8), stable=True)
    cat = cat[order][:out_cap]
    m = m[order][:out_cap]
    if cat.shape[0] < out_cap:
        pad = out_cap - cat.shape[0]
        cat = torch.cat([cat, cat.new_zeros((pad,) + tuple(cat.shape[1:]))], 0)
        m = torch.cat([m, m.new_zeros((pad,))], 0)
    return cat, m


def segment_count(seg: torch.Tensor, n: int) -> torch.Tensor:
    """int32 count of each id in [0, n); other ids are dropped, as
    ``jax.ops.segment_sum`` drops them.  (A scatter-add, not
    ``torch.bincount``, which has no vmap rule.)"""
    seg = torch.where((seg >= 0) & (seg < n), seg, torch.full_like(seg, n)).long()
    ones = torch.ones_like(seg, dtype=torch.int32)
    return ones.new_zeros((n + 1,)).scatter_add(0, seg, ones)[:n]
