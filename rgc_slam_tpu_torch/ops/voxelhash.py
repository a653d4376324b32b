"""Static-shape open-addressing voxel hash: the port of
``rgc_slam_tpu/ops/voxelhash.py``.

Slots match the JAX package bit for bit:

* the multiplicative hashes rely on int32 multiply wraparound; here they are
  computed in int64 and wrapped to int32 explicitly before the same
  ``abs`` and mask (``abs(INT32_MIN)`` stays INT32_MIN in int32 and becomes
  2**31 in int64; both mask to the same slot);
* slot claiming keeps the round-based scatter-min (``scatter_reduce`` with
  ``"amin"``, which is deterministic), not atomicCAS.

The segment sums become ``index_add``, which adds in no fixed order on
CUDA; they sum in float64 on every device and round once to float32, so
the result does not depend on that order unless the exact sum lies within
float64 rounding of a float32 rounding boundary, and the CPU runs the
card's arithmetic.  Sums agree with JAX to float tolerance, counts
exactly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..types import VoxelMap

INT32_MAX = 2**31 - 1
COORD_BITS = 10
COORD_OFFSET = 1 << (COORD_BITS - 1)       # 512
COORD_MASK = (1 << COORD_BITS) - 1
EMPTY = -1


def voxel_coords(pts: torch.Tensor, resolution, offset: float = 0.0) -> torch.Tensor:
    """Points [..., 3] -> int32 voxel coords; ``offset=0.5`` is the
    GaussianVoxelMap binning, ``0.0`` the VoxelGrid one."""
    return torch.floor(pts / resolution - offset).to(torch.int32)


def pack_coords(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[..., 3] int coords -> one non-negative int32 key; invalid or out of
    the ±512-voxel range -> -1 (callers origin-shift first)."""
    shifted = coords + COORD_OFFSET
    in_range = ((shifted >= 0) & (shifted <= COORD_MASK)).all(-1)
    key = (
        shifted[..., 0]
        | (shifted[..., 1] << COORD_BITS)
        | (shifted[..., 2] << (2 * COORD_BITS))
    )
    return torch.where(valid & in_range, key, torch.full_like(key, EMPTY))


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (still int64)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


def _mult_hash(key: torch.Tensor, mult: int, shift: int, cap: int) -> torch.Tensor:
    k = key.to(torch.int64)
    h = _wrap_int32(k * mult) ^ (k >> shift)
    h = _wrap_int32(torch.abs(h))           # int32 abs: INT32_MIN stays INT32_MIN
    return (h & (cap - 1)).to(torch.int32)


def _hash_key(key: torch.Tensor, cap: int) -> torch.Tensor:
    """Multiplicative hash of a packed key -> [0, cap); cap a power of 2."""
    return _mult_hash(key, -1640531527, 15, cap)


def _hash_step(key: torch.Tensor, cap: int) -> torch.Tensor:
    """Second hash for double hashing: an odd step."""
    return _mult_hash(key, -2048144789, 13, cap) | 1


class HashTable(NamedTuple):
    table_keys: torch.Tensor     # [CAP] int32, EMPTY where unused
    slot_of_point: torch.Tensor  # [N] int32, -1 for dropped/invalid points


def build_hash_table(keys: torch.Tensor, cap: int, probes: int = 16) -> HashTable:
    """Claim slots for (possibly duplicated) packed keys by rounds of
    scatter-min contention: each unassigned point proposes its key at its
    probe slot, the minimum key wins the slot, and every point whose key
    matches the slot's stored key is assigned."""
    n = keys.shape[0]
    dev = keys.device
    valid = keys >= 0
    h0 = _hash_key(keys, cap).long()
    step = _hash_step(keys, cap).long()
    table = torch.full((cap,), EMPTY, dtype=torch.int32, device=dev)
    slot_of_point = torch.full((n,), -1, dtype=torch.int32, device=dev)
    no_key = torch.full((n,), INT32_MAX, dtype=torch.int32, device=dev)
    for p in range(probes):
        cand = (h0 + p * step) & (cap - 1)
        need = (slot_of_point < 0) & valid
        attempt = need & (table[cand] == EMPTY)
        proposals = torch.where(attempt, keys, no_key)
        winner = torch.full((cap,), INT32_MAX, dtype=torch.int32, device=dev).scatter_reduce(
            0, cand, proposals, "amin")
        table = torch.where((table == EMPTY) & (winner < INT32_MAX), winner, table)
        match = table[cand] == keys
        slot_of_point = torch.where(need & match, cand.to(torch.int32), slot_of_point)
    return HashTable(table, slot_of_point)


def lookup_slots(table_keys: torch.Tensor, query_keys: torch.Tensor,
                 probes: int = 16) -> torch.Tensor:
    """Probe-chain lookup: slot index, or -1 if absent."""
    cap = table_keys.shape[0]
    h0 = _hash_key(query_keys, cap).long()
    step = _hash_step(query_keys, cap).long()
    slot = torch.full(query_keys.shape, -1, dtype=torch.int32, device=query_keys.device)
    done = query_keys < 0
    for p in range(probes):
        cand = (h0 + p * step) & (cap - 1)
        stored = table_keys[cand]
        hit = (~done) & (stored == query_keys)
        slot = torch.where(hit, cand.to(torch.int32), slot)
        done = done | hit | (stored == EMPTY)
    return slot


def segment_sum(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` over ``num`` segments, summed in float64 and
    rounded once to ``x``'s dtype (the same result in any order of adds)."""
    acc = x.double()
    return acc.new_zeros((num,) + tuple(x.shape[1:])).index_add(0, seg, acc).to(x.dtype)


def voxel_downsample(
    pts: torch.Tensor,
    mask: torch.Tensor,
    resolution,
    cap: int,
    extras: Optional[Tuple[torch.Tensor, ...]] = None,
    probes: int = 16,
):
    """Centroid voxel-grid downsample with static output shape [cap].
    Returns (points [cap,3], mask [cap], extras averaged per voxel)."""
    keys = pack_coords(voxel_coords(pts, resolution), mask)
    ht = build_hash_table(keys, cap, probes)
    slot = torch.where(ht.slot_of_point >= 0, ht.slot_of_point,
                       torch.full_like(ht.slot_of_point, cap)).long()
    ones = (slot < cap).to(pts.dtype)
    counts = segment_sum(ones, slot, cap + 1)[:cap]
    sums = segment_sum(pts * ones[:, None], slot, cap + 1)[:cap]
    denom = torch.clamp(counts, min=1.0)
    out_extras = []
    for e in extras or ():
        shape = (-1,) + (1,) * (e.ndim - 1)
        s = segment_sum(e * ones.reshape(shape), slot, cap + 1)[:cap]
        out_extras.append(s / denom.reshape(shape))
    return sums / denom[:, None], counts > 0, tuple(out_extras)


def build_gaussian_voxelmap(
    pts: torch.Tensor,
    covs: torch.Tensor,
    mask: torch.Tensor,
    resolution,
    cap: int,
    probes: int = 16,
) -> VoxelMap:
    """VGICP target voxel map (ADDITIVE mode): per-voxel mean of member
    points and of member covariances, half-voxel-shifted binning."""
    keys = pack_coords(voxel_coords(pts, resolution, offset=0.5), mask)
    ht = build_hash_table(keys, cap, probes)
    slot = torch.where(ht.slot_of_point >= 0, ht.slot_of_point,
                       torch.full_like(ht.slot_of_point, cap)).long()
    w = (slot < cap).to(pts.dtype)
    counts = segment_sum(w, slot, cap + 1)[:cap]
    mean = segment_sum(pts * w[:, None], slot, cap + 1)[:cap]
    covsum = segment_sum(covs * w[:, None, None], slot, cap + 1)[:cap]
    denom = torch.clamp(counts, min=1.0)
    return VoxelMap(
        keys=ht.table_keys,
        mean=mean / denom[:, None],
        cov=covsum / denom[:, None, None],
        num_points=counts,
        resolution=torch.tensor(resolution, dtype=pts.dtype, device=pts.device),
    )


def voxelmap_lookup(vm: VoxelMap, query_pts: torch.Tensor, probes: int = 16) -> torch.Tensor:
    """Query points -> voxel slots (-1 = no voxel), DIRECT1 search."""
    coords = voxel_coords(query_pts, vm.resolution, offset=0.5)
    keys = pack_coords(coords, torch.ones(query_pts.shape[:-1], dtype=torch.bool,
                                          device=query_pts.device))
    return lookup_slots(vm.keys, keys, probes)
