"""Feature front-end: the port of ``rgc_slam_tpu/ops/features.py``.

The whole scan is one flat padded tensor sorted ring-major; window
operations are zero-padded shifts, and the greedy pick runs every
(ring × sector) segment in parallel, round by round, exactly as the JAX
package does.  ``extract_features_sp`` is the sp-sharded variant: each
rank of the sp axis computes its block of rows of the windowed stack and
the covariances, and the blocks meet by psum (``utils/axes``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import SlamConfig
from ..types import FeatureCloud, GroundPlane, PointCloud, Struct, tree_map
from ..utils.cloud import range_filter_mask, segment_count
from ..utils.axes import axis_index, axis_size, psum
from ..utils.math3d import const, cross, eigh_or_nan, norm
from .covariance import eigh3x3


@dataclass
class FeatureExtraction(Struct):
    """Output of the front-end for one scan."""

    full: PointCloud          # organized (ring-major) cloud
    sharp: FeatureCloud
    flat: FeatureCloud
    inten: FeatureCloud
    ground: GroundPlane
    ground_mask: torch.Tensor     # [N] bool
    curvature: torch.Tensor       # [N]
    normals_cov: torch.Tensor     # [N, 3, 3]


# ---------------------------------------------------------------------------
# organization
# ---------------------------------------------------------------------------


def organize(cloud: PointCloud, cfg: SlamConfig):
    """Sort points ring-major (ring asc, time asc, invalid last; stable).
    Returns (organized cloud, ring_start [n_scans], ring_count [n_scans])."""
    big = torch.full((), 1e9, dtype=torch.float32, device=cloud.xyz.device)
    key = torch.where(cloud.mask, cloud.ring.to(torch.float32) * 10.0 + cloud.rel_time, big)
    order = torch.argsort(key, stable=True)
    out = tree_map(lambda a: a[order], cloud)
    seg = torch.where(cloud.mask, cloud.ring, torch.full_like(cloud.ring, cfg.n_scans))
    ring_count = segment_count(seg, cfg.n_scans)
    ring_start = torch.cat([ring_count.new_zeros(1),
                            torch.cumsum(ring_count, 0)[:-1].to(torch.int32)])
    return out, ring_start, ring_count


def _shift(x: torch.Tensor, o: int) -> torch.Tensor:
    """x[i+o] with true zero padding at the flat-array ends."""
    if o == 0:
        return x
    pad = x.new_zeros((abs(o),) + tuple(x.shape[1:]))
    if o > 0:
        return torch.cat([x[o:], pad], 0)
    return torch.cat([pad, x[:o]], 0)


# Dependency radius of the windowed stack (for block slicing): the deepest
# shift chain (intensity extents <- intensity gap <- smoothed intensity <-
# raw intensity) reaches 10-11 points; 12 adds margin.
_HALO = 12


def _strip(x: torch.Tensor, start: int, per: int, halo: int) -> torch.Tensor:
    """x[start-halo : start+per+halo] along axis 0 with true zero padding
    outside [0, n): ``_shift``'s boundary convention, so a window op on the
    strip trimmed by ``halo`` equals its full-array result exactly."""
    pad = x.new_zeros((halo,) + tuple(x.shape[1:]))
    padded = torch.cat([pad, x, pad], 0)
    start = min(max(int(start), 0), x.shape[0] - per)     # lax.dynamic_slice's clamp
    return padded[start:start + per + 2 * halo]


def _pointwise_block(xyz_f, inten_f, ring_f, mask_f, pos_f, count_f, start: int, per: int,
                     cfg: SlamConfig) -> dict:
    """The per-point windowed stack on rows [start, start + per):
    incidence smoothing, the curvature triple, ground seed + flood,
    occlusion and parallel-surface masks, and the gap-suppression extents.
    Inputs are the whole organized arrays; the block computes on a ±_HALO
    strip so every window op sees its true neighbours, then trims to its
    rows.  start=0, per=n is the replicated path (``extract_features``)."""
    h = _HALO
    xyz = _strip(xyz_f, start, per, h)
    inten_raw = _strip(inten_f, start, per, h)
    ring = _strip(ring_f, start, per, h)
    mask = _strip(mask_f, start, per, h)
    pos_in_ring = _strip(pos_f, start, per, h)
    count_of_ring = _strip(count_f, start, per, h)
    dtype = xyz.dtype
    dev = xyz.device
    L = xyz.shape[0]
    zero = torch.zeros((), dtype=dtype, device=dev)

    interior = mask & (pos_in_ring >= 5) & (pos_in_ring < count_of_ring - 5)
    r = norm(xyz)

    # ---- incidence angle for near points ----
    pa = _shift(xyz, 5)
    pb = _shift(xyz, -5)
    pc = 0.5 * (pa + pb)
    pnorm = cross(pa - pb, xyz - pc)
    denom = norm(pnorm) * torch.clamp(r, min=1e-6)
    scan_angle = torch.abs((pnorm * xyz).sum(-1) / torch.clamp(denom, min=1e-9))
    near = (r < 2.0) & interior
    scan_angle = torch.where(near, scan_angle, torch.ones((), dtype=dtype, device=dev))

    # ---- intensity smoothing at glancing incidence ----
    glancing = (scan_angle < 0.07) & near
    neigh_sum = torch.zeros_like(inten_raw)
    for o in range(-5, 6):
        if o != 0:
            neigh_sum = neigh_sum + _shift(inten_raw, o)
    inten = torch.where(glancing, 0.9 * inten_raw + 0.005 * neigh_sum, inten_raw)

    # ---- curvature triple ----
    def window_diff(x):
        s = -10.0 * x
        for o in range(-5, 6):
            if o != 0:
                s = s + _shift(x, o)
        return s

    diff_xyz = torch.stack([window_diff(xyz[:, k]) for k in range(3)], -1)
    diff_i = window_diff(inten)
    diff_r = window_diff(r)

    dis_factor = torch.clamp(2.0 / (1.0 + r / 20.0), min=0.2)
    curvature = (diff_xyz * diff_xyz).sum(-1) * dis_factor
    distance_source = 0.5 + dis_factor
    inten_curv = torch.where(glancing, (scan_angle + 0.3) * diff_i, diff_i)
    other_source = torch.where(glancing, scan_angle * 10.0 + 0.6,
                               torch.full_like(scan_angle, 3.0))
    curvature2 = torch.abs(diff_r * dis_factor)

    curvature = torch.where(interior, curvature, zero)
    curvature2 = torch.where(interior, curvature2, zero)
    inten_curv = torch.where(interior, inten_curv, zero)

    # ---- ground seed + neighbour flood ----
    expected = const(cfg.expected_ground_ranges, dtype, dev)
    gsi = cfg.ground_scan_rings
    in_ground_rings = (
        mask & (ring < gsi) & (pos_in_ring >= 5) & (pos_in_ring < count_of_ring - 5)
    )
    ring_c = torch.clamp(ring, 0, gsi).long()
    # integer division, as in the reference: a step function of the ring
    ring_step = torch.div(ring, gsi - 1, rounding_mode="floor").to(dtype)
    gate = cfg.ground_range_gate * (1.0 + ring_step)
    seed = in_ground_rings & (torch.abs(r - expected[ring_c]) < gate) & (xyz[:, 2] < cfg.ground_z_max)
    gw_all = 1.5 - ring_step
    w = torch.zeros((L,), dtype=dtype, device=dev)
    mult = torch.zeros((L,), dtype=dtype, device=dev)
    for o in range(-4, 6):           # o = seed_index - point_index
        hit = _shift(seed, o) & (torch.abs(r - _shift(r, o)) < _shift(gate, o) / 2.0) & mask
        w = w + torch.where(hit, _shift(gw_all, o), zero)
        mult = mult + hit.to(dtype)

    # ---- occlusion / steep-surface mask ----
    r_next = _shift(r, 1)
    same_ring_next = (ring == _shift(ring, 1)) & mask & _shift(mask, 1)
    occl_fwd = (r - r_next > 0.04 * r_next) & same_ring_next
    occl_bwd = (r_next - r > 0.04 * r) & same_ring_next
    blocked = torch.zeros((L,), dtype=torch.bool, device=dev)
    for o in range(0, 6):
        blocked = blocked | _shift(occl_fwd, o)
    for o in range(1, 7):
        blocked = blocked | _shift(occl_bwd, -o)
    if cfg.parallel_surface_check:
        az_step = 2.0 * torch.pi / torch.clamp(count_of_ring.to(dtype), min=1.0)
        thresh = (2.0 * r * az_step) ** 2
        d_next = ((_shift(xyz, 1) - xyz) ** 2).sum(-1)
        d_prev = ((_shift(xyz, -1) - xyz) ** 2).sum(-1)
        parallel = (d_next > thresh) & (d_prev > thresh)
        blocked = blocked | (parallel & interior)

    # ---- neighbour-gap suppression extents ----
    def extents(ok):
        ext_r = torch.zeros((L,), dtype=torch.int32, device=dev)
        run = torch.ones((L,), dtype=torch.bool, device=dev)
        for l in range(1, 6):
            run = run & _shift(ok, l - 1)
            ext_r = ext_r + run.to(torch.int32)
        ext_l = torch.zeros((L,), dtype=torch.int32, device=dev)
        run = torch.ones((L,), dtype=torch.bool, device=dev)
        for l in range(1, 6):
            run = run & _shift(ok, -l)
            ext_l = ext_l + run.to(torch.int32)
        return ext_l, ext_r

    gap_next = ((_shift(xyz, 1) - xyz) ** 2).sum(-1)
    ext_l, ext_r = extents((gap_next <= 0.05) & same_ring_next)
    igap = torch.abs(_shift(inten, 1) - inten)
    iext_l, iext_r = extents((igap <= 35.0) & same_ring_next)

    out = dict(
        interior=interior, intensity=inten, curvature=curvature,
        curvature2=curvature2, inten_curv=inten_curv,
        distance_source=distance_source, other_source=other_source,
        blocked=blocked, ext_l=ext_l, ext_r=ext_r, iext_l=iext_l,
        iext_r=iext_r, ground_w=w, ground_mult=mult, ground_mask=mult > 0,
    )
    return {k: v[h:h + per] for k, v in out.items()}


def _point_covariances(org: PointCloud, pos_in_ring, count_of_ring, cfg: SlamConfig,
                       row_start: int = 0, row_count: "int | None" = None):
    """Per-point covariances for VGICP: "scan" (ring-window PCA, the
    default) or "rbf" (Gaussian-kernel moments), both through
    ``cfg.cov_regularization``; optionally one block of query rows."""
    from .covariance import rbf_covariances, scan_covariances

    if cfg.cov_estimation == "rbf":
        return rbf_covariances(org.xyz, org.mask, cfg.rbf_kernel_width, cfg.rbf_kernel_max_dist,
                               cfg.cov_regularization, row_start=row_start, row_count=row_count)
    return scan_covariances(org.xyz, org.mask, org.ring, pos_in_ring, count_of_ring, cfg,
                            row_start=row_start, row_count=row_count)


# ---------------------------------------------------------------------------
# the main front-end
# ---------------------------------------------------------------------------


def _organize_preamble(cloud: PointCloud, cfg: SlamConfig):
    """Range gate + rear-cone cut, then ring-major organization."""
    mask0 = range_filter_mask(cloud.xyz, cloud.mask, cfg.minimum_range, cfg.maximum_range)
    org, ring_start, ring_count = organize(cloud.replace(mask=mask0), cfg)
    idx = torch.arange(cloud.capacity, device=cloud.xyz.device, dtype=torch.int32)
    rc = torch.clamp(org.ring, 0, cfg.n_scans - 1).long()
    pos_in_ring = idx - ring_start[rc]
    count_of_ring = ring_count[rc]
    return org, ring_start, ring_count, pos_in_ring, count_of_ring


def extract_features(cloud: PointCloud, cfg: SlamConfig, debug: bool = False):
    """Feature front-end.  With ``debug=True`` also returns the
    intermediate arrays the JAX package's debug dict holds."""
    dtype = cloud.xyz.dtype
    org, ring_start, ring_count, pos_in_ring, count_of_ring = _organize_preamble(cloud, cfg)
    pw = _pointwise_block(org.xyz, org.intensity, org.ring, org.mask, pos_in_ring,
                          count_of_ring, 0, cloud.capacity, cfg)
    ground = _ground_solve(org.xyz, pw["ground_w"], pw["ground_mult"], cfg, dtype)
    covs = _point_covariances(org, pos_in_ring, count_of_ring, cfg)
    sharp, flat, intenf, picks = _pick_and_pack(org, pos_in_ring, count_of_ring, pw, cfg, dtype)
    fx = FeatureExtraction(
        full=org, sharp=sharp, flat=flat, inten=intenf, ground=ground,
        ground_mask=pw["ground_mask"], curvature=pw["curvature"], normals_cov=covs,
    )
    if debug:
        dbg = {
            "xyz": org.xyz, "mask": org.mask, "interior": pw["interior"],
            "ring_start": ring_start, "ring_count": ring_count,
            "curvature": pw["curvature"], "curvature2": pw["curvature2"],
            "inten_curv": pw["inten_curv"], "intensity": pw["intensity"],
            "ground_mask": pw["ground_mask"], "blocked": pw["blocked"],
            "sharp_picked": picks[0], "flat_picked": picks[1],
            "inten_picked": picks[2],
            "distance_source": pw["distance_source"],
            "other_source": pw["other_source"],
            "rel_time": org.rel_time,
        }
        return fx, dbg
    return fx


# per-point fields the picker and the output read: gathered under sp (the
# debug-only intensity and the ground weights, already reduced into the
# plane, stay on their rank)
_SP_GATHERED = ("interior", "curvature", "curvature2", "inten_curv", "distance_source",
                "other_source", "blocked", "ext_l", "ext_r", "iext_l", "iext_r", "ground_mask")


def extract_features_sp(cloud: PointCloud, cfg: SlamConfig) -> FeatureExtraction:
    """Block-sharded feature front-end over the sp axis (``cfg.psum_axis``).

    Inputs are replicated on every rank.  Rank i computes rows [i·per,
    (i+1)·per) of the windowed stack and of the covariances on a ±_HALO
    strip sliced from the replicated arrays, the ground moments are summed
    over the axis, and the per-point blocks meet by a psum of zero buffers
    holding each rank's rows (exact: one contribution per row, and x + 0
    is exact); the cheap global stages (organize, picker, compaction) stay
    replicated.  Needs the axis size equal to ``cfg.sp_shards`` and
    ``cfg.sp_shards`` dividing the cloud capacity, checked here: a mismatch
    would double-count some blocks and drop others."""
    axis = cfg.psum_axis
    if axis is None or cfg.sp_shards <= 1:
        raise ValueError("extract_features_sp needs an sp mesh (psum_axis + sp_shards)")
    dtype = cloud.xyz.dtype
    n = cloud.capacity
    if n % cfg.sp_shards:
        raise ValueError(f"cloud capacity {n} not divisible by sp_shards={cfg.sp_shards}")
    axis_sz = axis_size(axis)
    if axis_sz != cfg.sp_shards:
        raise ValueError(f"sp mesh axis {axis!r} has size {axis_sz}, "
                         f"cfg.sp_shards={cfg.sp_shards}")
    per = n // cfg.sp_shards
    start = axis_index(axis) * per

    org, ring_start, ring_count, pos_in_ring, count_of_ring = _organize_preamble(cloud, cfg)
    pw = _pointwise_block(org.xyz, org.intensity, org.ring, org.mask, pos_in_ring,
                          count_of_ring, start, per, cfg)
    ground = _ground_solve(org.xyz[start:start + per], pw["ground_w"], pw["ground_mult"], cfg,
                           dtype, psum_axis=axis)
    covs = _point_covariances(org, pos_in_ring, count_of_ring, cfg, row_start=start,
                              row_count=per)

    def gather(x):
        buf = x.new_zeros((n,) + tuple(x.shape[1:]),
                          dtype=torch.int32 if x.dtype == torch.bool else x.dtype)
        buf = torch.cat([buf[:start], x.to(buf.dtype), buf[start + per:]], 0)
        out = psum(buf, axis)
        return out > 0 if x.dtype == torch.bool else out.to(x.dtype)

    pw = {k: gather(pw[k]) for k in _SP_GATHERED}
    covs = gather(covs)
    sharp, flat, intenf, _ = _pick_and_pack(org, pos_in_ring, count_of_ring, pw, cfg, dtype)
    return FeatureExtraction(
        full=org, sharp=sharp, flat=flat, inten=intenf, ground=ground,
        ground_mask=pw["ground_mask"], curvature=pw["curvature"], normals_cov=covs,
    )


# ---------------------------------------------------------------------------
# pickers + compaction
# ---------------------------------------------------------------------------


def _pick_and_pack(org: PointCloud, pos_in_ring, count_of_ring, pw: dict,
                   cfg: SlamConfig, dtype):
    """Sector segmentation, the three greedy picks, the degraded-geometry
    intensity merge, and fixed-size compaction."""
    xyz = org.xyz
    interior = pw["interior"]
    interior_len = torch.clamp(count_of_ring - 10, min=1)
    sector = torch.clamp(
        torch.div(cfg.n_sectors * (pos_in_ring - 5), interior_len, rounding_mode="floor"),
        0, cfg.n_sectors - 1,
    )
    n_segs = cfg.n_scans * cfg.n_sectors
    seg_id = torch.where(
        interior & (count_of_ring >= 20),
        org.ring * cfg.n_sectors + sector,
        torch.full_like(sector, n_segs),
    ).long()

    sharp_elig = (
        interior & ~pw["blocked"] & ~pw["ground_mask"]
        & (pw["curvature"] > cfg.sharp_curv_thresh)
        & (pw["curvature2"] > cfg.sharp_curv2_thresh)
    )
    sharp_picked, picked_any = _greedy_pick(
        pw["curvature"], sharp_elig, seg_id, n_segs, cfg.max_sharp_per_sector,
        pw["ext_l"], pw["ext_r"], descending=True,
    )
    flat_elig = (
        interior & ~pw["blocked"] & ~picked_any
        & (pw["curvature"] < cfg.flat_curv_thresh)
        & (pw["curvature2"] < cfg.flat_curv2_thresh)
    )
    flat_picked, _ = _greedy_pick(
        pw["curvature"], flat_elig, seg_id, n_segs, cfg.max_flat_per_sector,
        pw["ext_l"], pw["ext_r"], descending=False,
    )
    inten_elig = (
        interior & ~pw["ground_mask"] & ~sharp_picked
        & (pw["inten_curv"] > cfg.inten_curv_thresh)
    )
    inten_picked, _ = _greedy_pick(
        pw["inten_curv"], inten_elig, seg_id, n_segs, cfg.max_inten_per_sector,
        pw["iext_l"], pw["iext_r"], descending=True,
    )

    # degraded-geometry fallback: merge intensity corners into the sharp set
    n_sharp = sharp_picked.sum()
    n_flat = torch.clamp(flat_picked.sum(), min=1)
    merge = cfg.use_intensity & (n_sharp.to(dtype) / n_flat.to(dtype) < cfg.intensity_merge_ratio)
    sharp_out_mask = sharp_picked | (merge & inten_picked)
    sharp_conf = torch.where(inten_picked & ~sharp_picked, pw["other_source"],
                             pw["distance_source"] + 1.0)

    sharp = _compact(xyz, org.rel_time, sharp_conf, sharp_out_mask, cfg.max_sharp_total)
    flat = _compact(xyz, org.rel_time, pw["distance_source"], flat_picked, cfg.max_flat_total)
    intenf = _compact(xyz, org.rel_time, pw["other_source"], inten_picked, cfg.max_inten_total)
    return sharp, flat, intenf, (sharp_picked, flat_picked, inten_picked)


def _greedy_pick(score, eligible, seg_id, n_segs: int, rounds: int, ext_l, ext_r,
                 descending: bool):
    """Per-segment greedy pick with ±5 neighbour suppression: each round
    every segment picks its best eligible point (ties to the lowest index)
    and suppresses its gap-connected neighbours.  Returns (picked,
    picked-or-suppressed)."""
    n = score.shape[0]
    dev = score.device
    idx = torch.arange(n, device=dev)
    s = score if descending else -score
    neg_inf = torch.full_like(s, -torch.inf)
    picked = torch.zeros((n,), dtype=torch.bool, device=dev)
    suppressed = torch.zeros((n,), dtype=torch.bool, device=dev)
    for _ in range(rounds):
        ok = eligible & ~picked & ~suppressed
        val = torch.where(ok, s, neg_inf)
        seg_best = torch.full((n_segs + 1,), -torch.inf, dtype=s.dtype, device=dev).scatter_reduce(
            0, seg_id, val, "amax")
        best_here = ok & (val == seg_best[seg_id]) & torch.isfinite(val)
        cand_idx = torch.where(best_here, idx, torch.full_like(idx, n))
        seg_arg = torch.full((n_segs + 1,), n, dtype=idx.dtype, device=dev).scatter_reduce(
            0, seg_id, cand_idx, "amin")
        pick = best_here & (idx == seg_arg[seg_id])
        picked = picked | pick
        # suppression interval [i - ext_l, i + ext_r] via a difference array
        starts = torch.where(pick, torch.clamp(idx - ext_l, min=0), torch.full_like(idx, n))
        ends = torch.where(pick, torch.clamp(idx + ext_r + 1, max=n), torch.full_like(idx, n))
        inc = pick.to(torch.int32)
        delta = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
        delta = delta.index_add(0, starts, inc).index_add(0, ends, -inc)
        suppressed = suppressed | (torch.cumsum(delta[:-1], 0) > 0)
    return picked, picked | suppressed


def _compact(xyz, rel_time, conf, mask, cap: int) -> FeatureCloud:
    """Gather masked points into a fixed-size FeatureCloud (valid first)."""
    order = torch.argsort((~mask).to(torch.int8), stable=True)[:cap]
    m = mask[order]
    zero = torch.zeros((), dtype=xyz.dtype, device=xyz.device)
    return FeatureCloud(
        xyz=torch.where(m[:, None], xyz[order], zero),
        rel_time=torch.where(m, rel_time[order], zero),
        confidence=torch.where(m, conf[order], zero),
        mask=m,
    )


# ---------------------------------------------------------------------------
# ground plane solve
# ---------------------------------------------------------------------------


def _ground_eigh(cov: torch.Tensor):
    """The ground fit's 3x3 eigendecomposition (ascending).  On the card
    the closed form, ``ops/covariance.eigh3x3``: ``torch.linalg.eigh``
    reads its status back to the host there, which a CUDA graph cannot
    hold.  On the CPU LAPACK's (``utils.math3d.eigh_or_nan``), as the JAX
    package solves it: it reads nothing back there, and it rounds as JAX's
    does, which the CPU tests that hold whole sequences to JAX rely on (a
    last-bit change moves the reference's trajectory by centimetres within a
    few scans, PERF.md §6)."""
    return eigh3x3(cov) if cov.is_cuda else eigh_or_nan(cov)


def _ground_solve(xyz, w, mult, cfg: SlamConfig, dtype, psum_axis=None) -> GroundPlane:
    """Weighted PCA plane + robustified distance over the flooded ground set.

    The rows may be one rank's block: every moment sum is then summed over
    ``psum_axis`` and the 3x3 eigendecomposition (``_ground_eigh``) runs on
    every rank.  A non-finite moment (NaN coordinates in rows of weight 0)
    gives a NaN, invalid plane, as the JAX package's ``jnp.linalg.eigh``
    does."""

    def _red(x):
        return psum(x, psum_axis) if psum_axis is not None else x

    wsum = torch.clamp(_red(w.sum()), min=1e-6)
    center = _red((xyz * w[:, None]).sum(0)) / wsum
    d = xyz - center
    cov = _red(torch.einsum("n,ni,nj->ij", w, d, d)) / wsum
    evals, evecs = _ground_eigh(cov)  # ascending
    normal = evecs[:, 0]
    normal = torch.where(torch.dot(center, normal) < 0, -normal, normal)
    planarity_ok = evals[1] > cfg.ground_planarity_ratio * evals[0]

    d_unit = d / torch.clamp(norm(d, keepdim=True), min=1e-9)
    dw = 1.0 - 100.0 * torch.abs(d_unit @ normal)
    dw = torch.where(dw < 0, torch.full_like(dw, 0.1), dw) * mult
    dwsum = torch.clamp(_red(dw.sum()), min=1e-6)
    distance = _red((dw * (xyz @ normal)).sum()) / dwsum
    gsize = torch.clamp(_red(mult.sum()), min=1.0)
    source1 = dwsum / gsize

    h = cfg.lidar_height
    ratio = distance / h
    h_t = torch.full_like(distance, h)
    distance = torch.where((ratio > 1.1) | (ratio < 0.9), h_t, distance)
    distance = torch.where(source1 < 0.9, 0.9 * h + 0.1 * distance, distance)
    valid = (_red((mult > 0).sum()) > 0) & planarity_ok
    return GroundPlane(
        normal=normal.to(dtype), v1=evecs[:, 1].to(dtype), v2=evecs[:, 2].to(dtype),
        distance=distance.to(dtype), source=(1.0 - source1).to(dtype), valid=valid,
    )
