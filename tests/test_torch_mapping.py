"""models/mapping of the port against the JAX module on the same inputs.

The inputs are captured from the JAX engine itself: the synthetic sequence
of tests/test_mapping.py runs through JAX ``slam_step`` for 8 scans, then
scan 8's step is traced with spies that return the arguments of
``mapping_step`` and ``scan_to_map_solve``, and the JAX state crosses to the port through
``bridge.state_from_numpy``.  Gates (the JAX suite's stage-6 oracle gates):
line/plane accept masks exactly, the four solved poses within 1e-4.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu.models import mapping as jmap
from rgc_slam_tpu.models import slam as jslam
from rgc_slam_tpu_torch import bridge
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.models import mapping as tmap
from rgc_slam_tpu_torch.models.odometry import OdometryOutput
from rgc_slam_tpu_torch.types import GroundPlane

torch.set_num_threads(1)
N_CARRY = 8


def _jax_state_dict(state):
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in leaves}


def _t(x):
    if hasattr(x, "normal"):
        return GroundPlane(**{f: _t(getattr(x, f))
                              for f in ("normal", "v1", "v2", "distance", "source", "valid")})
    return torch.from_numpy(np.array(x)) if not isinstance(x, (int, float)) else x


@pytest.fixture(scope="module")
def captured():
    seq = synthetic.generate_sequence(
        n_scans=N_CARRY + 2, n_azimuth=360, seed=5, extent=18.0, radius=8.0,
        noise=0.004, motion_distortion=True, closes_loop=False, speed=2.0,
    )
    step = jax.jit(functools.partial(jslam.slam_step, cfg=JCFG))
    state = jslam.SlamState.init(JCFG)

    def inputs(k):
        t_imu, acc, gyr = seq["imu"][k]
        return (cloud_from_scan_dict(seq["scans"][k], JCFG),
                imu_from_interval(t_imu, acc, gyr, JCFG.max_imu),
                jnp.asarray(seq["stamps"][k], jnp.float32))

    for k in range(N_CARRY):
        state, _ = step(state, *inputs(k))

    def capture(state, cloud, imu, stamp):
        """slam_step with spies on mapping_step and scan_to_map_solve that
        return their (array) arguments as outputs of the jitted program."""
        rec = {}
        orig_step, orig_solve = jmap.mapping_step, jmap.scan_to_map_solve

        def step_spy(*args):
            rec["step"] = args[:-1]                      # all but cfg
            return orig_step(*args)

        def solve_spy(*args, **kw):
            rec["solve"] = args[:-2]                     # all but gn_axis, cfg
            return orig_solve(*args, **kw)

        jmap.mapping_step, jmap.scan_to_map_solve = step_spy, solve_spy
        try:
            jslam.slam_step(state, cloud, imu, stamp, JCFG)
        finally:
            jmap.mapping_step, jmap.scan_to_map_solve = orig_step, orig_solve
        return rec["step"], rec["solve"]

    step_args, solve_args = jax.jit(capture)(state, *inputs(N_CARRY))
    return state, tuple(solve_args) + (None, JCFG), tuple(step_args)


def test_assemble_local_map_matches(captured):
    state, args, _ = captured
    t0 = np.asarray(args[1])
    jout = jmap.assemble_local_map(state.mapping, jnp.asarray(t0), JCFG)
    tstate = bridge.state_from_numpy(_jax_state_dict(state), TCFG, "cpu")
    tout = tmap.assemble_local_map(tstate.mapping, _t(t0), TCFG)
    for j, t, name in zip(jout, tout, ("cm_pts", "cm_mask", "sm_pts", "sm_mask")):
        if name.endswith("mask"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
            assert t.numpy().sum() > 50
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, err_msg=name)


def _queries(args):
    q0, t0 = np.asarray(args[0]), np.asarray(args[1])
    corner, surf = np.asarray(args[4]), np.asarray(args[10])
    R = np.asarray(jax.numpy.asarray(jmap.m3.quat_to_mat(jnp.asarray(q0))))
    return (corner @ R.T + t0).astype(np.float32), (surf @ R.T + t0).astype(np.float32)


def test_edge_and_plane_correspondences_match(captured):
    _, args, _ = captured
    c_w, s_w = _queries(args)
    c_conf, c_mask = args[5], args[6]
    s_conf, s_mask = args[11], args[12]
    cm, cmm, sm, smm = args[16], args[17], args[18], args[19]
    je = jmap.edge_correspondences(jnp.asarray(c_w), c_conf, c_mask, cm, cmm, JCFG)
    te = tmap.edge_correspondences(_t(c_w), _t(c_conf), _t(c_mask), _t(cm), _t(cmm), TCFG)
    np.testing.assert_array_equal(te.w.numpy() > 0, np.asarray(je.w) > 0)
    assert (te.w.numpy() > 0).sum() > 20
    ok = te.w.numpy() > 0
    # the line direction's sign is the eigen solver's choice: compare the
    # endpoint pair unordered
    ja, jb, ta, tb = (np.asarray(x)[ok] for x in (je.pa, je.pb, te.pa, te.pb))
    same = np.maximum(np.abs(ta - ja).max(1), np.abs(tb - jb).max(1))
    swap = np.maximum(np.abs(ta - jb).max(1), np.abs(tb - ja).max(1))
    assert np.minimum(same, swap).max() < 1e-4
    jp = jmap.plane_correspondences(jnp.asarray(s_w), s_conf, s_mask, sm, smm, JCFG)
    tp = tmap.plane_correspondences(_t(s_w), _t(s_conf), _t(s_mask), _t(sm), _t(smm), TCFG)
    np.testing.assert_array_equal(tp.w.numpy() > 0, np.asarray(jp.w) > 0)
    assert (tp.w.numpy() > 0).sum() > 100
    ok = tp.w.numpy() > 0
    np.testing.assert_allclose(tp.n.numpy()[ok], np.asarray(jp.n)[ok], atol=1e-4)
    np.testing.assert_allclose(tp.d.numpy()[ok], np.asarray(jp.d)[ok], atol=1e-4, rtol=1e-4)


def test_lstsq_qr_matches(rng):
    A = (rng.normal(size=(256, 5, 3)) + np.array([14.0, -3.0, 2.0])).astype(np.float32)
    b = -np.ones((256, 5), np.float32)
    np.testing.assert_allclose(tmap._lstsq_qr(_t(A), _t(b)).numpy(),
                               np.asarray(jmap._lstsq_qr(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-4, atol=1e-5)


def test_scan_to_map_solve_matches(captured):
    _, args, _ = captured
    jres = jax.jit(lambda *a: jmap.scan_to_map_solve(*a, None, JCFG, debug=True))(*args[:-2])
    # the sp arguments (rep_scale, gn_axis) come before cfg, as in JAX
    targs = [_t(a) for a in args[:-2]] + [None, TCFG]
    tres = tmap.scan_to_map_solve(*targs, debug=True)
    (jq, jt, jql, jtl), (jne, jnp_), jdbg = jres
    (tq, tt, tql, ttl), (tne, tnp), tdbg = tres
    np.testing.assert_array_equal(tne.numpy(), np.asarray(jne))
    np.testing.assert_array_equal(tnp.numpy(), np.asarray(jnp_))
    for i in range(TCFG.map_opt_iterations):
        for c in range(4):                       # ec, ecl, pc, pcl
            np.testing.assert_array_equal(tdbg[i][c].w.numpy() > 0,
                                          np.asarray(jdbg[c].w)[i] > 0)
    for j, t in [(jq, tq), (jt, tt), (jql, tql), (jtl, ttl)]:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


def test_mapping_step_matches(captured):
    """The whole mapping step from the same JAX state and odometry output."""
    state, _, call = captured
    ms, odo, cx, cc, cm, sx, sc, sm, ypr, stamp = call
    jstate, jout = jax.jit(functools.partial(jmap.mapping_step, cfg=JCFG))(
        ms, odo, cx, cc, cm, sx, sc, sm, ypr, stamp)
    tstate = bridge.state_from_numpy(_jax_state_dict(state), TCFG, "cpu").mapping
    todo = OdometryOutput(*[_t(x) for x in odo[:7]], None, _t(odo.deskewed_sharp_xyz),
                          _t(odo.deskewed_flat_xyz), _t(odo.ground), _t(odo.gflag))
    tstate2, tout = tmap.mapping_step(tstate, todo, *[_t(x) for x in (cx, cc, cm, sx, sc, sm,
                                                                         ypr, stamp)], TCFG)
    np.testing.assert_allclose(tout.t_w.numpy(), np.asarray(jout.t_w), atol=1e-4)
    np.testing.assert_allclose(tout.q_w.numpy(), np.asarray(jout.q_w), atol=1e-4)
    assert bool(tout.kf_added) == bool(jout.kf_added)
    assert int(tout.n_surf_factors) == int(jout.n_surf_factors)
    assert int(tstate2.kf_count) == int(jstate.kf_count)
    np.testing.assert_allclose(tstate2.kf_t.numpy(), np.asarray(jstate.kf_t), atol=1e-4)


def test_compact_keyframe_store_matches():
    K = TCFG.max_keyframes
    js = jmap.MappingState.init(JCFG)
    xs = np.zeros((K, 3), np.float32)
    xs[:, 0] = np.arange(K) * 0.5
    js = js.replace(kf_t=jnp.asarray(xs), kf_count=jnp.asarray(K - 4, jnp.int32),
                    kf_stamp=jnp.asarray(np.arange(K, dtype=np.float32)))
    protect = np.zeros(K, bool)
    protect[3] = True
    jm2, jkeep, jnoo = jmap.compact_keyframe_store(js, jnp.asarray(protect))
    ts = bridge.tree_from_numpy(tmap.MappingState.init(TCFG, "cpu"), _jax_state_dict(js), "cpu")
    tm2, tkeep, tnoo = tmap.compact_keyframe_store(ts, torch.from_numpy(protect))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tnoo.numpy(), np.asarray(jnoo))
    assert int(tm2.kf_count) == int(jm2.kf_count)
    np.testing.assert_array_equal(tm2.kf_t.numpy(), np.asarray(jm2.kf_t))
    np.testing.assert_array_equal(tm2.kf_stamp.numpy(), np.asarray(jm2.kf_stamp))
    for cadence, chunk in [(10, 1), (10, 8), (10, 5), (10, 16), (7, 3)]:
        assert tmap.worst_cadence_gap(cadence, chunk) == jmap.worst_cadence_gap(cadence, chunk)
