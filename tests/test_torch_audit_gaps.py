"""JAX-suite paths that the coverage map (tests/test_torch_coverage.py)
found no other port test holding, each through the port as the JAX test
runs it, and against the JAX package where both can run the same inputs.

* checkpoint and resume (tests/test_aux.py:79): scans 0-3, save, restore,
  scans 4-7 equal the uninterrupted run (1e-5, the JAX test's gate);
* ``loop_edges`` of an empty loop store (test_aux.py:132);
* ``corridor_world``'s clutter options (test_aux.py:260): the same boxes,
  cylinders and cast scans as JAX's, and the JAX test's invariants;
* ``pack_coords`` out of range and ``voxel_downsample`` of an all-masked
  cloud (test_voxelhash.py:15, :62), and ``build_hash_table`` under
  ``torch.func.vmap`` (test_voxelhash.py:90: every slot claimed, each lane
  equal to its own call and to JAX's vmapped slots);
* ``PcdSink`` writing an empty frame (test_runtime.py:97): JAX's bytes;
* ``extract_features`` twice on one cloud (test_features.py:79): bit-equal;
* the "plane" loop ICP on an empty store (test_gicp_variants.py:324):
  nothing accepted, no loop stored;
* ``imu_preint_residual`` at the truth (test_gicp_variants.py:240): below
  1e-4 and within 1e-6 of JAX's;
* the preintegrated rotation variance (test_imu_preint.py:93): grows with
  the window and the gyro noise, as JAX's does, traces within 1e-5
  relative of JAX's;
* the startup gyro-bias estimate inside ``complementary_filter_scan``
  (test_odometry.py:138): with it the yaw drift stays bounded, without it
  the bias integrates, and the moving-from-power-on guard; the bias and
  yaws within 1e-5 of JAX's.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import export as j_export
from rgc_slam_tpu.io import synthetic as j_syn
from rgc_slam_tpu.models import loop as jloop
from rgc_slam_tpu.models.slam import SlamState as JSlamState
from rgc_slam_tpu.ops import factors as jfac
from rgc_slam_tpu.ops import imu as jimu
from rgc_slam_tpu.ops import voxelhash as jvh
from rgc_slam_tpu.runtime import loader as j_loader
from rgc_slam_tpu.types import ImuBatch as JImuBatch
from rgc_slam_tpu.utils import math3d as jm3
from rgc_slam_tpu_torch import bridge
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io import export as t_export
from rgc_slam_tpu_torch.io import synthetic as t_syn
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud, imu_from_interval as t_imu
from rgc_slam_tpu_torch.models import loop as tloop
from rgc_slam_tpu_torch.models import slam as tslam
from rgc_slam_tpu_torch.ops import factors as tfac
from rgc_slam_tpu_torch.ops import features as tF
from rgc_slam_tpu_torch.ops import imu as timu
from rgc_slam_tpu_torch.ops import voxelhash as tvh
from rgc_slam_tpu_torch.runtime import loader as t_loader
from rgc_slam_tpu_torch.types import ImuBatch as TImuBatch
from rgc_slam_tpu_torch.utils import checkpoint as t_ckpt
from rgc_slam_tpu_torch.utils import math3d as tm3
from rgc_slam_tpu_torch.utils.lanes import strict_vmap

torch.set_num_threads(1)


def _state_dict(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in leaves}


def _t(x):
    return torch.from_numpy(np.array(x))


def test_resume_continues_identically(tmp_path):
    seq = t_syn.generate_sequence(n_scans=8, n_azimuth=240, seed=2, extent=15.0, radius=6.0,
                                  noise=0.004, closes_loop=False, speed=1.5)

    def run(state, lo, hi):
        for k in range(lo, hi):
            t_i, acc, gyr = seq["imu"][k]
            state, _ = tslam.slam_step(state, t_cloud(seq["scans"][k], TCFG, "cpu"),
                                       t_imu(t_i, acc, gyr, TCFG.max_imu, "cpu"),
                                       torch.tensor(seq["stamps"][k], dtype=torch.float32), TCFG)
        return state

    half = run(tslam.SlamState.init(TCFG, "cpu"), 0, 4)
    full = run(half, 4, len(seq["scans"]))
    t_ckpt.save(str(tmp_path / "mid"), (half,), step=4, cfg=TCFG)
    (resumed,), step = t_ckpt.restore(str(tmp_path / "mid"), (tslam.SlamState.init(TCFG, "cpu"),))
    assert step == 4
    again = run(resumed, 4, len(seq["scans"]))
    np.testing.assert_allclose(again.mapping.t_w_last.numpy(), full.mapping.t_w_last.numpy(),
                               atol=1e-5)


def test_loop_edges_empty():
    ms = JSlamState.init(JCFG).mapping
    ls = jloop.LoopState.init(JCFG)
    t_ms = bridge.tree_from_numpy(tslam.SlamState.init(TCFG, "cpu").mapping, _state_dict(ms),
                                  "cpu")
    t_ls = bridge.loop_state_from_numpy(_state_dict(ls), TCFG, "cpu")
    edges = t_export.loop_edges(t_ms, t_ls)
    assert edges.shape == j_export.loop_edges(ms, ls).shape == (0, 2, 3)


def test_corridor_world_clutter_options():
    worlds = {}
    for name, syn in (("jax", j_syn), ("port", t_syn)):
        blank = syn.corridor_world(length=70.0, width=8.0)
        w = syn.corridor_world(length=70.0, width=8.0, alcove_spacing=24.0, pillar_spacing=24.0)
        scans = [syn.cast_scan(x, np.eye(3), np.array([-12.0, 0.0, 0.56]), n_rings=16,
                               n_azimuth=360, rng=np.random.default_rng(0), noise=0.0)
                 for x in (w, blank)]
        worlds[name] = (blank, w, scans)
    blank, w, (sc, sb) = worlds["port"]
    assert w.boxes.shape[0] > blank.boxes.shape[0] == 4
    assert w.cylinders.shape[0] >= 2 and blank.cylinders.shape[0] == 0
    ys = w.boxes[4:, 1] + w.boxes[4:, 4]
    assert (ys > 0).any() and (ys < 0).any()
    assert not np.allclose(sc["xyz"], sb["xyz"])
    j_blank, j_w, (j_sc, j_sb) = worlds["jax"]
    for a, b in ((blank, j_blank), (w, j_w)):
        np.testing.assert_array_equal(a.boxes, b.boxes)
        np.testing.assert_array_equal(a.cylinders, b.cylinders)
    for a, b in ((sc, j_sc), (sb, j_sb)):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_pack_out_of_range_and_empty_downsample(rng):
    coords = np.array([[600, 0, 0], [-600, 3, 1], [5, 5, 5]], np.int32)
    keys = tvh.pack_coords(_t(coords), torch.ones(3, dtype=torch.bool)).numpy()
    assert keys[0] == keys[1] == -1 and keys[2] >= 0
    np.testing.assert_array_equal(keys, np.asarray(jvh.pack_coords(jnp.asarray(coords),
                                                                    jnp.ones(3, bool))))
    pts = rng.uniform(-5, 5, (50, 3)).astype(np.float32)
    _, omask, _ = tvh.voxel_downsample(_t(pts), torch.zeros(50, dtype=torch.bool), 1.0, cap=64)
    _, j_omask, _ = jvh.voxel_downsample(jnp.asarray(pts), jnp.zeros(50, bool), 1.0, cap=64)
    assert not omask.any() and not np.asarray(j_omask).any()


def test_hash_table_under_vmap(rng):
    pts = rng.uniform(-10, 10, (4, 500, 3)).astype(np.float32)

    def t_build(p):
        keys = tvh.pack_coords(tvh.voxel_coords(p, 1.0),
                               torch.ones(p.shape[0], dtype=torch.bool, device=p.device))
        return tvh.build_hash_table(keys, cap=1024).slot_of_point

    @jax.jit
    @jax.vmap
    def j_build(p):
        keys = jvh.pack_coords(jvh.voxel_coords(p, 1.0), jnp.ones(p.shape[0], bool))
        return jvh.build_hash_table(keys, cap=1024).slot_of_point

    with strict_vmap():
        slots = torch.func.vmap(t_build)(_t(pts)).numpy()
    assert (slots >= 0).all()
    for b in range(4):
        np.testing.assert_array_equal(slots[b], t_build(_t(pts[b])).numpy())
    np.testing.assert_array_equal(slots, np.asarray(j_build(jnp.asarray(pts))))


def test_pcd_sink_empty_frame(tmp_path):
    for name, loader in (("jax", j_loader), ("port", t_loader)):
        with loader.PcdSink(str(tmp_path / name), ring_slots=2) as sink:
            sink.push(0, np.zeros((0, 3), np.float32))
    port = tmp_path / "port" / "frame_000000.pcd"
    assert port.read_bytes() == (tmp_path / "jax" / "frame_000000.pcd").read_bytes()
    xyz, _ = t_export.read_pcd(str(port))
    assert len(xyz) == 0


def test_feature_determinism():
    scan = t_syn.cast_scan(t_syn.default_world(0), np.eye(3), np.array([0.0, 0.0, 0.56]),
                           n_rings=16, n_azimuth=240, noise=0.005)
    cloud = t_cloud(scan, TCFG, "cpu")
    a, b = tF.extract_features(cloud, TCFG), tF.extract_features(cloud, TCFG)
    np.testing.assert_array_equal(a.sharp.mask.numpy(), b.sharp.mask.numpy())
    np.testing.assert_array_equal(a.sharp.xyz.numpy(), b.sharp.xyz.numpy())
    np.testing.assert_array_equal(a.flat.xyz.numpy(), b.flat.xyz.numpy())


def test_loop_plane_method_on_an_empty_store():
    cfg = dataclasses.replace(TCFG, loop_icp_method="plane")
    _, ls2, info = tloop.loop_closure_step(tslam.SlamState.init(cfg, "cpu"),
                                           tloop.LoopState.init(cfg, "cpu"), cfg)
    assert not bool(info.accepted)
    assert int(ls2.loop_count) == 0


def test_imu_preint_residual_zero_at_truth():
    m = 20
    ts = (np.arange(m) * 0.005 + 0.005).astype(np.float32)
    acc = np.tile(np.float32([0.2, 0.1, 9.81]), (m, 1))
    gyr = np.tile(np.float32([0.1, -0.05, 0.3]), (m, 1))
    out = {}
    for name, imu_mod, fac, m3, batch, cast in (
            ("jax", jimu, jfac, jm3, JImuBatch, jnp.asarray),
            ("port", timu, tfac, tm3, TImuBatch, _t)):
        imu = batch(t=cast(ts), acc=cast(acc), gyr=cast(gyr), mask=cast(np.ones(m, bool)))
        zero = cast(np.zeros(3, np.float32))
        pre = imu_mod.preintegrate(imu, cast(np.float32(0.0)), cast(np.float32(0.1)), zero, zero)
        q_i, p_i, v_i = m3.quat_identity(), zero, zero
        G = cast(np.float32([0.0, 0.0, 9.81]))
        dt = pre.sum_dt
        v_j = v_i + m3.quat_rotate(q_i, pre.delta_v) - G * dt
        p_j = p_i + v_i * dt + m3.quat_rotate(q_i, pre.delta_p) - 0.5 * G * dt * dt
        out[name] = np.asarray(fac.imu_preint_residual(
            p_i, q_i, v_i, zero, zero, p_j, pre.delta_q, v_j, zero, zero,
            pre.delta_p, pre.delta_q, pre.delta_v, dt))
    assert np.abs(out["port"]).max() < 1e-4
    np.testing.assert_allclose(out["port"], out["jax"], atol=1e-6, rtol=0)


def test_rotation_variance_sets_delta_r_weight():
    gyr_n = 0.004

    def batch(cls, cast, m):
        ts = (0.005 * (1 + np.arange(m))).astype(np.float32)
        return cls(t=cast(ts), acc=cast(np.tile(np.float32([0.1, -0.2, 9.81]), (m, 1))),
                   gyr=cast(np.tile(np.float32([0.02, -0.01, 0.3]), (m, 1))),
                   mask=cast(np.ones(m, bool)))

    traces = {}
    for name, imu_mod, cls, cast in (("jax", jimu, JImuBatch, jnp.asarray),
                                     ("port", timu, TImuBatch, _t)):
        zero = cast(np.zeros(3, np.float32))

        def v(m, t1, noise):
            f = imu_mod.preintegrate_full(batch(cls, cast, m), cast(np.float32(0.0)),
                                          cast(np.float32(t1)), zero, zero, gyr_n=noise)
            return float(np.trace(np.asarray(f.cov)[3:6, 3:6]))

        traces[name] = np.array([v(20, 0.1, gyr_n), v(80, 0.4, gyr_n), v(20, 0.1, 5 * gyr_n)])
    short, long, noisy = traces["port"]
    assert long > 3.5 * short
    assert noisy > 20 * short
    np.testing.assert_allclose(traces["port"], traces["jax"], rtol=1e-5)


def test_bias_init_bounds_yaw_drift():
    g = np.random.default_rng(11)
    bg_true = np.array([0.001, -0.002, 0.005])
    hz, grav, t_static, t_rot, wz = 200.0, 9.81, 3.0, 27.0, 0.4
    n_static, n_rot = int(t_static * hz), int(t_rot * hz)
    n = n_static + n_rot
    t = np.arange(1, n + 1) / hz
    rate = np.zeros((n, 3))
    rate[n_static:, 2] = wz
    gyr = rate + bg_true[None, :] + g.normal(0, 1e-4, (n, 3))
    acc = np.array([0.0, 0.0, grav])[None, :] + g.normal(0, 0.01, (n, 3))
    yaw_true = wz * (t[-1] - t_static)
    win = 64
    windows = [{"t": t[k:k + win].astype(np.float32), "acc": acc[k:k + win].astype(np.float32),
                "gyr": gyr[k:k + win].astype(np.float32),
                "mask": np.ones(min(win, n - k), bool)} for k in range(0, n, win)]

    def run_port(state):
        for w in windows:
            state = timu.complementary_filter_scan(state, TImuBatch(**{k: _t(v) for k, v in w.items()}))
        return state

    j_step = jax.jit(jimu.complementary_filter_scan)

    def run_jax(state):
        for w in windows:
            state = j_step(state, JImuBatch(**{k: jnp.asarray(v) for k, v in w.items()}))
        return state

    init_t, init_j = timu.ImuFilterState.init("cpu"), jimu.ImuFilterState.init()
    s_on, j_on = run_port(init_t), run_jax(init_j)
    s_off = run_port(init_t.replace(bias_ready=torch.tensor(True)))
    j_off = run_jax(init_j.replace(bias_ready=jnp.asarray(True)))
    assert bool(s_on.bias_ready)
    np.testing.assert_allclose(s_on.bg.numpy(), bg_true, atol=5e-4)
    err_on = abs(float(tm3.wrap_angle(s_on.yaw - yaw_true)))
    err_off = abs(float(tm3.wrap_angle(s_off.yaw - yaw_true)))
    assert err_on < 0.02 and err_off > 0.1, (err_on, err_off)
    np.testing.assert_allclose(s_on.bg.numpy(), np.asarray(j_on.bg), atol=1e-5, rtol=0)
    for a, b in ((s_on, j_on), (s_off, j_off)):
        assert abs(float(tm3.wrap_angle(a.yaw - torch.tensor(float(b.yaw))))) <= 1e-5
    cap = timu.WARM_CAP
    s_move = run_port(init_t.replace(warm_gyr=torch.full((cap, 3), 0.3),
                                     warm_acc=torch.full((cap, 3), 5.0),
                                     warm_n=torch.tensor(cap, dtype=torch.int32)))
    assert bool(s_move.bias_ready)
