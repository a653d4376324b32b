"""The port's block-sharded feature front-end (``extract_features_sp``) on
gloo ranks against JAX's under ``shard_map`` on the virtual CPU mesh.

The inputs and gates are tests/test_features_sp.py's: a 220-azimuth scan
of ``default_world(seed=3)`` at TEST_CONFIG.  Feature masks and the ground
mask must match exactly, feature xyz to 1e-7 and confidences to 1e-5;
curvature at rtol 1e-3 / atol 5e-3 (the curvature window is a cancellation
of 11 near-equal terms), covariances at rtol 1e-4 / atol 1e-5 and the ground
plane at 1e-4 (its moment sums are reassociated by the psum).

The plane-regularized covariances are held to the port's own replicated
front-end at the file's gate, row for row.  Against JAX, the rbf
covariances are held row by row (tests/torch_cov_gates.py): each row
within the largest of the file's gate, twice JAX's own move of that row
under two 1e-7 relative perturbations of the scan (an rbf weight flips at
the 3 m cutoff; a near-tie of the two smallest eigenvalues leaves the
plane normal ill-defined), and the float32 rounding of the row's one-pass
moments.  The scan covariances, whose only sensitivity is the eigenvector
choice, meet the file's gate on every row whose raw spectrum separates
its smallest eigenvalue from the middle one by 3% of the largest (the rule
of tests/test_torch_features.py), and no row differs by more than
max(the file's gate, twice JAX's largest own move).  Every rank
of the port must return the same bits.  The ranks run in spawned processes
(``parallel.distributed.run_ranks``), their bodies in tests/torch_sp_ranks.py.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_sp_ranks as ranks
from torch_cov_gates import assert_rows_track, rbf_rounding, rows_max
from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud
from rgc_slam_tpu.ops import features as jf
from rgc_slam_tpu.parallel import fleet as jfleet
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.parallel import distributed, fleet as tfleet
from rgc_slam_tpu_torch.parallel.distributed import run_ranks

torch.set_num_threads(1)
TIMEOUT_S = 240
FIELDS = ("xyz", "intensity", "rel_time", "ring", "mask")


def _sp(cfg, n_sp, **kw):
    return dataclasses.replace(cfg, psum_axis="sp", sp_shards=n_sp, sp_features=True, **kw)


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(42)          # the JAX file's rng fixture
    world = synthetic.default_world(seed=3, extent=18.0)
    scan = synthetic.cast_scan(world, np.eye(3), np.array([0.3, -0.2, 0.56]),
                               n_rings=JCFG.n_scans, n_azimuth=220, rng=rng, noise=0.01)
    return j_cloud(scan, JCFG)


def _variants(cloud):
    """The JAX clouds of the cases: as cast, all masked, NaN xyz in the
    masked slots."""
    return {
        "scan": cloud,
        "empty": cloud.replace(mask=jnp.zeros_like(cloud.mask)),
        "nan": cloud.replace(xyz=jnp.where(cloud.mask[:, None], cloud.xyz, jnp.nan)),
    }


def _arrays(jcloud):
    return {k: np.array(getattr(jcloud, k)) for k in FIELDS}


@functools.lru_cache(maxsize=None)
def _jax_sp_fn(cfg, n_dev):
    mesh = Mesh(np.array(jax.devices()[:n_dev]), axis_names=("sp",))
    return jax.jit(jax.shard_map(functools.partial(jf.extract_features_sp, cfg=cfg),
                                 mesh=mesh, in_specs=P(), out_specs=P()))


def _jax_leaf(fx, name):
    obj = fx
    for part in name.split("."):
        obj = getattr(obj, part)
    return np.asarray(obj)


@pytest.fixture(scope="module")
def port2(cloud):
    """Two ranks: the scan, its rbf variant, the all-masked and the NaN
    scans, and an indivisible capacity (the last raises)."""
    v = _variants(cloud)
    odd = {k: a[:-1] for k, a in _arrays(cloud).items()}     # 4095 rows
    cases = [(_arrays(v["scan"]), _sp(TCFG, 2)),
             (_arrays(v["scan"]), _sp(TCFG, 2, cov_estimation="rbf")),
             (_arrays(v["empty"]), _sp(TCFG, 2)),
             (_arrays(v["nan"]), _sp(TCFG, 2)),
             (odd, _sp(TCFG, 2))]
    return run_ranks(ranks.features_sp, 2, "cpu", (cases,), timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def port4(cloud):
    """Four ranks: the scan at sp_shards=4, and at sp_shards=2 (raises)."""
    cases = [(_arrays(cloud), _sp(TCFG, 4)), (_arrays(cloud), _sp(TCFG, 2))]
    return run_ranks(ranks.features_sp, 4, "cpu", (cases,), timeout_s=TIMEOUT_S)


def _ranks_agree(outs, case):
    first = outs[0][case]
    for other in outs[1:]:
        assert set(other[case]) == set(first)
        for k in first:
            np.testing.assert_array_equal(other[case][k], first[k], err_msg=k)
    return first


def _assert_covs_track_jax(got, ref, jax_fn, jcloud, jcfg):
    """The rule of the module docstring."""
    xyz = np.asarray(jcloud.xyz)
    own = 0.0
    for seed in (1, 2):
        g = np.random.default_rng(seed)
        p = (xyz * (1 + 1e-7 * g.standard_normal(xyz.shape))).astype(np.float32)
        moved = np.asarray(jax_fn(jcloud.replace(xyz=jnp.asarray(p))).normals_cov)
        own = np.maximum(own, rows_max(moved - ref))
    raw = dataclasses.replace(jcfg, psum_axis=None, sp_shards=1, sp_features=False,
                              cov_regularization="none")
    org, _, _, pos, cnt = jf._organize_preamble(jcloud, raw)
    if jcfg.cov_estimation == "rbf":
        assert_rows_track(got, ref, own, rbf_rounding(np.asarray(org.xyz), np.asarray(org.mask),
                                                      jcfg.cov_regularization))
        return
    assert np.abs(got - ref).max() <= max(1e-5 + 1e-4 * np.abs(ref).max(), 2 * own.max())
    ev = np.linalg.eigvalsh(np.asarray(jf._point_covariances(org, pos, cnt, raw), np.float64))
    sep = (ev[:, 1] - ev[:, 0]) > 3e-2 * ev[:, 2]
    assert sep[np.asarray(org.mask)].mean() > 0.7
    np.testing.assert_allclose(got[sep], ref[sep], rtol=1e-4, atol=1e-5)


def _replicated(cloud_arrays, tcfg):
    cfg = dataclasses.replace(tcfg, psum_axis=None, sp_shards=1, sp_features=False)
    from rgc_slam_tpu_torch.ops import features as tf
    from rgc_slam_tpu_torch.types import PointCloud

    fx = tf.extract_features(PointCloud(**{k: torch.from_numpy(v)
                                            for k, v in cloud_arrays.items()}), cfg)
    return fx.normals_cov.numpy()


def _assert_gates(got, ref):
    for name in ("sharp", "flat", "inten"):
        np.testing.assert_array_equal(got[f"{name}.mask"], _jax_leaf(ref, f"{name}.mask"))
        np.testing.assert_allclose(got[f"{name}.xyz"], _jax_leaf(ref, f"{name}.xyz"),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(got[f"{name}.confidence"],
                                   _jax_leaf(ref, f"{name}.confidence"), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["ground_mask"], _jax_leaf(ref, "ground_mask"))
    np.testing.assert_allclose(got["curvature"], _jax_leaf(ref, "curvature"), rtol=1e-3,
                               atol=5e-3)
    np.testing.assert_allclose(got["ground.normal"], _jax_leaf(ref, "ground.normal"), atol=1e-4)
    np.testing.assert_allclose(got["ground.distance"], _jax_leaf(ref, "ground.distance"),
                               atol=1e-4)
    assert bool(got["ground.valid"]) == bool(_jax_leaf(ref, "ground.valid"))


@pytest.mark.parametrize("n_sp", [2, 4])
def test_features_sp_matches_jax(cloud, port2, port4, n_sp):
    got = _ranks_agree(port2 if n_sp == 2 else port4, 0)
    fn = _jax_sp_fn(_sp(JCFG, n_sp), n_sp)
    ref = fn(cloud)
    _assert_gates(got, ref)
    _assert_covs_track_jax(got["normals_cov"], np.asarray(ref.normals_cov), fn, cloud, JCFG)
    np.testing.assert_allclose(got["normals_cov"], _replicated(_arrays(cloud), TCFG),
                               rtol=1e-4, atol=1e-5)
    assert got["sharp.mask"].sum() > 10 and got["flat.mask"].sum() > 10


def test_features_sp_rbf_covariances(cloud, port2):
    got = _ranks_agree(port2, 1)
    jcfg = _sp(JCFG, 2, cov_estimation="rbf")
    fn = _jax_sp_fn(jcfg, 2)
    ref = fn(cloud)
    _assert_gates(got, ref)
    _assert_covs_track_jax(got["normals_cov"], np.asarray(ref.normals_cov), fn, cloud, jcfg)
    np.testing.assert_allclose(got["normals_cov"],
                               _replicated(_arrays(cloud), _sp(TCFG, 2, cov_estimation="rbf")),
                               rtol=1e-4, atol=1e-5)


def test_features_sp_degenerate_scans(cloud, port2):
    """All masked: no features, an invalid ground plane, finite covariances.
    NaN in the masked slots: JAX's sharp mask, finite feature points, and
    JAX's invalid ground plane."""
    v = _variants(cloud)
    fn = _jax_sp_fn(_sp(JCFG, 2), 2)
    empty = _ranks_agree(port2, 2)
    assert not empty["sharp.mask"].any() and not empty["flat.mask"].any()
    assert not bool(empty["ground.valid"])
    assert np.isfinite(empty["normals_cov"]).all()
    ref = fn(v["empty"])
    np.testing.assert_array_equal(empty["ground_mask"], np.asarray(ref.ground_mask))

    nan = _ranks_agree(port2, 3)
    ref = fn(v["nan"])
    np.testing.assert_array_equal(nan["sharp.mask"], np.asarray(ref.sharp.mask))
    np.testing.assert_array_equal(nan["flat.mask"], np.asarray(ref.flat.mask))
    assert np.isfinite(nan["sharp.xyz"][nan["sharp.mask"]]).all()
    assert bool(nan["ground.valid"]) == bool(ref.ground.valid)
    np.testing.assert_array_equal(np.isnan(nan["ground.normal"]),
                                  np.isnan(np.asarray(ref.ground.normal)))


def test_features_sp_rejects_bad_shards(port2, port4):
    """A mesh axis wider than cfg.sp_shards, and a capacity sp_shards does
    not divide, raise ValueError on every rank (the JAX function's
    trace-time checks), instead of double-counting blocks in the gather."""
    for outs, case, match in ((port4, 1, "has size 4, cfg.sp_shards=2"),
                              (port2, 4, "not divisible by sp_shards=2")):
        for rank_out in outs:
            assert isinstance(rank_out[case], str) and match in rank_out[case], rank_out[case]


def test_sp_plan_fallbacks():
    """The plan's two fallbacks are independent, as the JAX package's:
    an indivisible max_points turns off only the sp front-end, indivisible
    registration capacities drop to stride masking; the step builds in
    every mode."""
    for kw in (dict(max_points=4095), dict(), dict(max_kf_corner=127)):
        jplan = jfleet._sp_plan(dataclasses.replace(JCFG, sp_features=True, **kw), 2)
        tplan = tfleet._sp_plan(dataclasses.replace(TCFG, sp_features=True, **kw), 2)
        assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan), kw
    assert tfleet._sp_plan(dataclasses.replace(TCFG, sp_features=True, max_points=4095), 2) \
        .sp_shards == 2
    mesh = distributed.Mesh(n_dp=4, n_sp=2, dp=0, sp=0, groups={}, device=torch.device("cpu"))
    tfleet.make_distributed_step(mesh, dataclasses.replace(TCFG, sp_features=True,
                                                           max_points=4095))
