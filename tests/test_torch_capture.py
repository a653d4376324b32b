"""The port's step reads nothing on the host: what a captured CUDA graph
(``utils/graph``) needs, checked on the CPU.

* ``slam_step`` (loops off) at TEST_CONFIG and at a FLEET_CONFIG-like
  config, at ``mapping_skip_frame=2``, on a scan that compacts the keyframe
  store inline (``max_keyframes=3``), and ``fleet_step_compacting`` over 3
  robots, and at ``degeneracy_thresh`` > 0: under a ``TorchDispatchMode`` that counts
  ``aten._local_scalar_dense`` (every ``bool()``, ``.item()`` or index by a
  0-dim tensor: a host read of the device) and ``aten.lift_fresh`` (a
  tensor built from Python data: a blocking copy to the device), the second
  scan on makes none of either;
* ``utils.math3d.eigh_jacobi`` (the degeneracy projection's 12x12)
  against numpy's float64 eigh on seeded matrices, and
  ``degeneracy_projection`` against JAX's on a 12-dim problem blind to
  three directions;
* the card's ground fit (``ops/covariance.eigh3x3``, no host read; the CPU
  keeps LAPACK's, ``ops/features._ground_eigh``) against the JAX package's
  (``jnp.linalg.eigh``) on seeded planar clouds, at the features tests'
  1e-4;
* ``lm_drive`` at its static iteration counts: the λ trace against JAX's on
  tests/test_registration.py's scan pair (accepted steps and rejects
  exactly, y0 and λ at 1e-3 relative, as tests/test_torch_registration.py
  gates them), and the iterations past the exit change nothing, bit for
  bit;
* ``utils.graph.CompiledStep`` on a CPU state calls the step itself;
* with tracing on (the stage marks a traced capture records, here
  ``graph.marking`` with a stand-in event) ``slam_step`` and
  ``fleet_step_compacting`` read nothing on the host either.
"""
import dataclasses
import functools
from collections import Counter

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.ops import factors as jfac
from rgc_slam_tpu.ops import features as jfeat
from rgc_slam_tpu.ops import registration as jreg
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io import synthetic
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu_torch.models.slam import SlamState, make_chunk_step, slam_step
from rgc_slam_tpu_torch.ops.covariance import eigh3x3
from rgc_slam_tpu_torch.ops import factors as tfac
from rgc_slam_tpu_torch.ops import features as tfeat
from rgc_slam_tpu_torch.ops import registration as treg
from rgc_slam_tpu_torch.parallel import fleet
from rgc_slam_tpu_torch.types import VoxelMap, tree_map
from rgc_slam_tpu_torch.utils import graph
from rgc_slam_tpu_torch.utils import math3d as m3
from test_registration import CFG as JREG_CFG, _downsample_with_covs, _prep, pair  # noqa: F401
from rgc_slam_tpu.ops import voxelhash as jvh

torch.set_num_threads(1)

HOST_OPS = ("aten._local_scalar_dense", "aten.lift_fresh")

# FLEET_CONFIG's shape at TEST_CONFIG's size: the fleet's own options
# (inline compaction off), its source-to-surf capacity ratios
FLEET_LIKE = dataclasses.replace(TCFG, max_source_points=512, max_kf_corner=64,
                                 max_kf_surf=256, max_map_points=2048,
                                 inline_compaction=False)
NO_LOOPS = dataclasses.replace(TCFG, loop_closure_enable=False)
CASES = {
    "default": (NO_LOOPS, 2),
    "fleet-like": (FLEET_LIKE, 2),
    "mapping_skip_frame=2": (dataclasses.replace(NO_LOOPS, mapping_skip_frame=2), 3),
    # a keyframe every scan into a store of 3: scan 4 compacts it inline
    "inline compaction": (dataclasses.replace(NO_LOOPS, max_keyframes=3, keyframe_dist=0.0,
                                              keyframe_angle=0.0), 4),
    # the mapping solve's 12x12 projection (utils.math3d.eigh_jacobi)
    "degeneracy_thresh=200": (dataclasses.replace(NO_LOOPS, degeneracy_thresh=200.0), 2),
}


class HostOps(TorchDispatchMode):
    """Counts the operators of ``HOST_OPS`` dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in HOST_OPS:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_scans=6, n_azimuth=120, seed=9, extent=15.0,
                                       radius=6.0, noise=0.004, closes_loop=False, speed=1.5)


def _inputs(seq, k, cfg):
    t_imu, acc, gyr = seq["imu"][k]
    return (cloud_from_scan_dict(seq["scans"][k], cfg, "cpu"),
            imu_from_interval(t_imu, acc, gyr, cfg.max_imu, "cpu"),
            torch.tensor(seq["stamps"][k], dtype=torch.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_slam_step_makes_no_host_reads(seq, case):
    cfg, n_scans = CASES[case]
    state = SlamState.init(cfg, "cpu")
    counts = []
    for k in range(n_scans):
        ins = _inputs(seq, k, cfg)
        with HostOps() as mode:
            state, out = slam_step(state, *ins, cfg)
        counts.append(dict(mode.counts))
        assert torch.isfinite(out.t_map).all()
    assert all(not c for c in counts[1:]), counts
    if case == "inline compaction":
        # the store filled at scan 3, and scan 4 evicted the second
        # keyframe, then added its own
        stamps = state.mapping.kf_stamp.numpy()
        assert int(state.mapping.kf_count) == 3
        np.testing.assert_array_equal(stamps, np.float32(seq["stamps"])[[0, 2, 3]])


def test_fleet_step_makes_no_host_reads(seq):
    cfg, B = FLEET_LIKE, 3
    states = fleet.fleet_init(cfg, B, "cpu")
    counts = []
    for k in range(2):
        cloud, imu, stamp = _inputs(seq, k, cfg)
        batch = tree_map(lambda a: a.expand(B, *a.shape).contiguous(), (cloud, imu))
        with HostOps() as mode:
            states, outs = fleet.fleet_step_compacting(states, *batch, stamp.expand(B), cfg)
        counts.append(dict(mode.counts))
        assert outs.t_map.shape == (B, 3) and torch.isfinite(outs.t_map).all()
    assert not counts[1], counts


STAGES = ["features", "odometry_pre", "vgicp_lm", "odometry_post", "downsample", "mapping"]


class _Event:
    """A stand-in for the card's timing event: ``graph.mark`` records it."""

    def record(self):
        pass


@pytest.mark.parametrize("case", ["default", "fleet-like"])
def test_traced_slam_step_makes_no_host_reads(seq, case):
    """With tracing on (``graph.marking``, as a traced capture runs the
    step) the step still reads nothing on the host from its second scan,
    and passes each stage's mark once, in order."""
    cfg, n_scans = CASES[case]
    state = SlamState.init(cfg, "cpu")
    counts = []
    for k in range(n_scans):
        ins = _inputs(seq, k, cfg)
        with graph.marking(_Event) as marks, HostOps() as mode:
            state, out = slam_step(state, *ins, cfg)
        counts.append(dict(mode.counts))
        assert [name for name, _ in marks] == STAGES
        assert out.lm_iters.shape == (3,)
    assert all(not c for c in counts[1:]), counts


def test_traced_fleet_step_makes_no_host_reads(seq):
    cfg, B = FLEET_LIKE, 3
    states = fleet.fleet_init(cfg, B, "cpu")
    counts = []
    for k in range(2):
        cloud, imu, stamp = _inputs(seq, k, cfg)
        batch = tree_map(lambda a: a.expand(B, *a.shape).contiguous(), (cloud, imu))
        with graph.marking(_Event) as marks, HostOps() as mode:
            states, outs = fleet.fleet_step_compacting(states, *batch, stamp.expand(B), cfg)
        counts.append(dict(mode.counts))
        assert [name for name, _ in marks] == STAGES
        assert outs.lm_iters.shape == (B, 3)
    assert not counts[1], counts


def test_compiled_step_on_cpu_is_the_step(seq):
    """On a CPU state ``CompiledStep`` and ``make_chunk_step`` call the step
    itself (the CPU runs it one op at a time, the same every time): two
    compiled single steps and one compiled chunk of two agree bit for bit,
    and nothing is captured."""
    cfg = NO_LOOPS
    step = functools.partial(slam_step, cfg=cfg)
    ins = [_inputs(seq, k, cfg) for k in range(2)]
    compiled, chunked = graph.CompiledStep(step), make_chunk_step(step, 2)
    s, outs = SlamState.init(cfg, "cpu"), []
    for x in ins:
        s, o = compiled(s, *x)
        outs.append(o)
    s2, outs2 = chunked(SlamState.init(cfg, "cpu"), *[v for x in ins for v in x])
    for x, y in zip(pytree.tree_leaves((s, outs)), pytree.tree_leaves((s2, outs2))):
        assert torch.equal(x, y)
    assert not compiled.graphs and not chunked.graphs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eigh_jacobi_matches_numpy(seed):
    """Symmetric 12x12s of eigenvalues 1e-5..1e7 (and one with two exact
    zero rows): eigenvalues within 1e-12 of the largest, and V orthogonal
    and diagonalizing A to float64's last bits."""
    g = np.random.default_rng(seed)
    J = g.normal(size=(4, 200, 12)) * np.exp(g.uniform(-6, 4, size=(4, 1, 12)))
    J[3, :, 3:5] = 0.0
    A = np.einsum("bni,bnj->bij", J, J)
    w, V = m3.eigh_jacobi(torch.from_numpy(A))
    w, V = w.numpy(), V.numpy()
    scale = np.abs(A).max((1, 2))
    np.testing.assert_array_less(np.abs(w - np.linalg.eigvalsh(A)).max(1), 1e-12 * scale)
    np.testing.assert_allclose(np.einsum("bji,bjk->bik", V, V), np.broadcast_to(np.eye(12), A.shape),
                               atol=1e-13)
    D = np.einsum("bji,bjk,bkl->bil", V, A, V)
    np.testing.assert_allclose(D, np.einsum("bi,ij->bij", w, np.eye(12)), atol=1e-13 * scale.max())


def test_degeneracy_projection_matches_jax_at_12():
    g = np.random.default_rng(3)
    A = (g.normal(size=(60, 12)) * np.exp(g.uniform(-2, 3, size=12))).astype(np.float32)
    A[:, [2, 7, 11]] = 0.0
    b = g.normal(size=60).astype(np.float32)
    jP, jn = jfac.degeneracy_projection(lambda x: jnp.asarray(A) @ x + jnp.asarray(b), 12, 1e-3)
    tP, tn = tfac.degeneracy_projection(lambda x, c: c["A"] @ x + c["b"], 12, 1e-3,
                                        dict(A=torch.from_numpy(A), b=torch.from_numpy(b)))
    assert int(tn) == int(jn) == 3
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), atol=1e-5)


def _planar_cloud(seed: int):
    """A ground patch (tilted plane at the sensor height, 5 mm noise) beside
    scattered wall points: xyz [n, 3], weights w and flood counts mult, as
    ``_ground_solve`` takes them."""
    g = np.random.default_rng(seed)
    n = 600
    xy = g.uniform(-12, 12, size=(n, 2)) * np.array([1.0, 0.6])
    tilt = g.normal(0, 0.03, size=2)
    z = -0.56 + xy @ tilt + g.normal(0, 0.005, size=n)
    xyz = np.concatenate([xy, z[:, None]], 1)
    wall = g.uniform(-8, 8, size=(n // 4, 3)) + np.array([0.0, 9.0, 1.0])
    xyz = np.concatenate([xyz, wall]).astype(np.float32)
    mult = np.concatenate([g.integers(1, 4, size=n), np.zeros(n // 4)]).astype(np.float32)
    w = (mult * g.uniform(0.5, 1.5, size=mult.shape)).astype(np.float32)
    return xyz, w, mult


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ground_fit_matches_jax_eigh(seed, monkeypatch):
    # the card's solver, here on the CPU
    monkeypatch.setattr(tfeat, "_ground_eigh", eigh3x3)
    xyz, w, mult = _planar_cloud(seed)
    jg = jfeat._ground_solve(jnp.asarray(xyz), jnp.asarray(w), jnp.asarray(mult), JCFG,
                             jnp.float32)
    tg = tfeat._ground_solve(torch.from_numpy(xyz), torch.from_numpy(w),
                             torch.from_numpy(mult), TCFG, torch.float32)
    assert bool(tg.valid) == bool(jg.valid) and bool(tg.valid)
    for f in ("normal", "distance", "source"):
        np.testing.assert_allclose(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    # the in-plane axes are eigenvectors up to sign (LAPACK's choice)
    for f in ("v1", "v2"):
        jv, tv = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert min(np.abs(jv - tv).max(), np.abs(jv + tv).max()) < 1e-4, f


@pytest.fixture(scope="module")
def pair_inputs(pair):
    sa, sb, _, _ = pair
    fa, fb = _prep(sa), _prep(sb)
    tgt, tgt_cov, tgt_mask = _downsample_with_covs(fa, JREG_CFG.target_voxel_size, 4096)
    vm = jvh.build_gaussian_voxelmap(tgt, tgt_cov, tgt_mask, JREG_CFG.vgicp_resolution,
                                     JREG_CFG.max_voxels)
    src = _downsample_with_covs(fb, JREG_CFG.source_voxel_size, JREG_CFG.max_source_points)
    return vm, src


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-12))


def test_lm_trace_at_static_counts(pair_inputs):
    vm, (src, cov, mask) = pair_inputs
    q0, t0 = np.array([1, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    jres, jtr = jax.jit(functools.partial(jreg.lm_register, cfg=JREG_CFG, with_trace=True))(
        src, cov, mask, vm, jnp.asarray(q0), jnp.asarray(t0))
    tvm = VoxelMap(**{f: torch.from_numpy(np.array(getattr(vm, f)))
                      for f in ("keys", "mean", "cov", "num_points", "resolution")})
    T = lambda x: torch.from_numpy(np.array(x))
    args = (T(src), T(cov), T(mask), tvm, T(q0), T(t0))
    tres, ttr = treg.lm_register(*args, TCFG, with_trace=True)
    n = int(jtr["n_outer"])
    assert int(ttr["n_outer"]) == n and 2 <= n < TCFG.vgicp_max_iterations
    np.testing.assert_array_equal(ttr["accepted"].numpy()[:n], np.asarray(jtr["accepted"])[:n])
    np.testing.assert_array_equal(ttr["n_rejects"].numpy()[:n], np.asarray(jtr["n_rejects"])[:n])
    assert _rel(ttr["lam_after"].numpy()[:n - 1], np.asarray(jtr["lam_after"])[:n - 1]) < 1e-3
    assert _rel(ttr["y0"].numpy()[:n], np.asarray(jtr["y0"])[:n]) < 1e-3
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=1e-4)
    # the iterations past the exit are dropped: a count that ends right at
    # the exit gives the same bits as the config's
    short = dataclasses.replace(TCFG, vgicp_max_iterations=n)
    sres, strace = treg.lm_register(*args, short, with_trace=True)
    for a, b in zip(sres._replace(bodies=None), tres._replace(bodies=None)):
        assert a is b is None or torch.equal(a, b)
    # the masked driver runs every body of its static counts
    for res, c in ((sres, short), (tres, TCFG)):
        assert int(res.bodies) == c.vgicp_max_iterations * (2 + c.lm_max_inner)
    for key in ("y0", "lam_after", "n_rejects", "accepted"):
        assert torch.equal(strace[key], ttr[key][:n]), key
        assert torch.isnan(ttr[key][n:]).all() if ttr[key].is_floating_point() else \
            not ttr[key][n:].any(), key
