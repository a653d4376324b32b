"""ops/voxelhash of the port against the JAX module.

Hash slots, table keys, masks and counts must match exactly.  Voxel sums
(means, averaged extras, covariances) are gated at 1e-5 absolute: they are
float32 segment sums whose order may differ.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.ops import voxelhash as jv
from rgc_slam_tpu_torch.ops import voxelhash as tv

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


@pytest.mark.parametrize("cap", [256, 4096, 16384])
def test_hashes_bit_exact_incl_int32_edge(rng, cap):
    keys = rng.integers(0, 2**30, 4000).astype(np.int32)
    # keys whose products wrap int32, and those whose hash hits INT32_MIN
    edge = np.array([0, 1, 2**30 - 1, (1 << 30) - 2, 2**29, 1_073_741_823, -1,
                     1309307523, 1500000000, 2**31 - 1], np.int64).astype(np.int32)
    keys = np.concatenate([keys, edge])
    _eq(jv._hash_key(jnp.asarray(keys), cap), tv._hash_key(_t(keys), cap))
    _eq(jv._hash_step(jnp.asarray(keys), cap), tv._hash_step(_t(keys), cap))


def test_pack_coords_and_bins(rng):
    pts = rng.uniform(-150, 150, (3000, 3)).astype(np.float32)
    mask = rng.random(3000) > 0.2
    for res, off in [(0.2, 0.0), (1.0, 0.5), (0.4, 0.0)]:
        jc = jv.voxel_coords(jnp.asarray(pts), res, off)
        tc = tv.voxel_coords(_t(pts), res, off)
        _eq(jc, tc)
        _eq(jv.pack_coords(jc, jnp.asarray(mask)), tv.pack_coords(tc, _t(mask)))


@pytest.mark.parametrize("n,cap,probes", [(3000, 1024, 16), (6000, 8192, 16), (500, 64, 4)])
def test_build_hash_table_and_lookup_exact(rng, n, cap, probes):
    # clustered points -> many duplicate keys per voxel, and overflow when
    # the distinct keys exceed cap
    pts = rng.normal(0, 6, (n, 3)).astype(np.float32)
    mask = rng.random(n) > 0.1
    keys = np.asarray(jv.pack_coords(jv.voxel_coords(jnp.asarray(pts), 0.5), jnp.asarray(mask)))
    jh = jv.build_hash_table(jnp.asarray(keys), cap, probes)
    th = tv.build_hash_table(_t(keys), cap, probes)
    _eq(jh.table_keys, th.table_keys)
    _eq(jh.slot_of_point, th.slot_of_point)
    q = np.concatenate([keys[:1000], rng.integers(0, 2**30, 500).astype(np.int32)])
    _eq(jv.lookup_slots(jh.table_keys, jnp.asarray(q), probes),
        tv.lookup_slots(th.table_keys, _t(q), probes))


def test_voxel_downsample(rng):
    n = 5000
    pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    mask = rng.random(n) > 0.1
    conf = rng.random(n).astype(np.float32)
    cov = rng.normal(size=(n, 3, 3)).astype(np.float32)
    jp, jm, (jc, jcv) = jv.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.8, 4096,
                                            extras=(jnp.asarray(conf), jnp.asarray(cov)))
    tp, tm, (tc, tcv) = tv.voxel_downsample(_t(pts), _t(mask), 0.8, 4096,
                                            extras=(_t(conf), _t(cov)))
    _eq(jm, tm)
    for j, t in [(jp, tp), (jc, tc), (jcv, tcv)]:
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=1e-5, rtol=0)


def test_build_gaussian_voxelmap_and_lookup(rng):
    n = 6000
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    mask = rng.random(n) > 0.05
    cov = rng.normal(size=(n, 3, 3)).astype(np.float32)
    jm = jv.build_gaussian_voxelmap(jnp.asarray(pts), jnp.asarray(cov), jnp.asarray(mask), 1.0, 8192)
    tm = tv.build_gaussian_voxelmap(_t(pts), _t(cov), _t(mask), 1.0, 8192)
    _eq(jm.keys, tm.keys)
    _eq(jm.num_points, tm.num_points)
    np.testing.assert_allclose(np.asarray(tm.mean), np.asarray(jm.mean), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(tm.cov), np.asarray(jm.cov), atol=1e-5, rtol=0)
    q = pts[:2000] + rng.normal(0, 0.5, (2000, 3)).astype(np.float32)
    _eq(jv.voxelmap_lookup(jm, jnp.asarray(q)), tv.voxelmap_lookup(tm, _t(q)))
