"""The port's copies of the numpy-only modules against the JAX package's files.

``rgc_slam_tpu_torch/io/gnss.py``, ``utils/oracle.py`` and ``utils/parity.py``
are copies, so that the port imports nothing of the JAX package (the GPU
machine has no JAX).  Each public function must give the same arrays,
numbers and bytes as the original on the inputs the JAX tests use
(tests/test_aux.py, tests/test_oracle.py, tests/test_parity_oracles.py).
"""
import dataclasses
import inspect
import types

import numpy as np
import pytest
import torch

import test_parity_oracles as po
from rgc_slam_tpu.io import gnss as j_gnss
from rgc_slam_tpu.utils import oracle as j_oracle
from rgc_slam_tpu.utils import parity as j_parity
from rgc_slam_tpu_torch.config import TEST_CONFIG
from rgc_slam_tpu_torch.io import gnss as t_gnss
from rgc_slam_tpu_torch.io import synthetic
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict
from rgc_slam_tpu_torch.ops import features
from rgc_slam_tpu_torch.utils import oracle as t_oracle
from rgc_slam_tpu_torch.utils import parity as t_parity

torch.set_num_threads(1)
PORT = types.SimpleNamespace(gnss=t_gnss, oracle=t_oracle, parity=t_parity)
JAX = types.SimpleNamespace(gnss=j_gnss, oracle=j_oracle, parity=j_parity)
PAIRS = {"gnss": (t_gnss, j_gnss), "oracle": (t_oracle, j_oracle), "parity": (t_parity, j_parity)}


def _same(a, b, path="out"):
    """Equal structure and types, bit-equal arrays and numbers (NaN where
    the other has NaN)."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        _same(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for key in a:
            _same(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float):
        assert type(b) is float and (a == b or (a != a and b != b)), (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _scan_debug():
    """The features' debug arrays of tests/test_oracle.py's first scan."""
    seq = synthetic.generate_sequence(n_scans=2, n_azimuth=360, seed=5, extent=18.0, radius=8.0,
                                      noise=0.004, closes_loop=False, speed=2.0)
    _, dbg = features.extract_features(cloud_from_scan_dict(seq["scans"][0], TEST_CONFIG, "cpu"),
                                       TEST_CONFIG, debug=True)
    return {k: v.numpy() for k, v in dbg.items()}


def _fixes(m):
    return (m.gnss.GnssFix(t=0, latitude=45.0, longitude=10.0, altitude=100.0),
            m.gnss.GnssFix(t=1, latitude=45.00001, longitude=10.0, altitude=101.0),
            m.gnss.GnssFix(t=2, latitude=45.0, longitude=10.00001, altitude=100.0))


def _gnss_track(m, out):
    track = m.gnss.GnssTrack()
    pushed = [track.push(m.gnss.GnssFix(t=i * 0.1, latitude=45 + i * 1e-5, longitude=10.0,
                                        altitude=0)) for i in range(5)]
    out.mkdir()
    track.dump_tum(str(out / "rtk.txt"))
    return pushed, track.as_arrays(), (out / "rtk.txt").read_bytes()


def _pick(m, _):
    dbg = _scan_debug()
    cfg = TEST_CONFIG
    return m.oracle.reference_pick(
        dbg["xyz"], dbg["curvature"], dbg["curvature2"], dbg["inten_curv"], dbg["intensity"],
        dbg["ground_mask"], dbg["blocked"], dbg["ring_start"], dbg["ring_count"],
        max_sharp=cfg.max_sharp_per_sector, max_flat=cfg.max_flat_per_sector,
        max_inten=cfg.max_inten_per_sector)


def _ground_fit(m, _):
    dbg = _scan_debug()
    xyz = dbg["xyz"].astype(np.float64)
    cfg = TEST_CONFIG
    return m.parity.reference_ground_fit(
        xyz, np.linalg.norm(xyz, axis=-1), dbg["ring_count"], list(cfg.expected_ground_ranges),
        ground_scan_rings=cfg.ground_scan_rings, range_gate=cfg.ground_range_gate,
        lidar_height=cfg.lidar_height, ground_z_max=cfg.ground_z_max)


def _vgicp(seed=7):
    src, src_cov, tgt, tgt_cov = po._vgicp_problem(seed=seed)
    T = np.eye(4)
    c, s = np.cos(0.02), np.sin(0.02)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = [0.1, 0.05, -0.08]
    return src, src_cov, tgt, tgt_cov, T


def _linearize(m, _):
    src, src_cov, tgt, tgt_cov, T = _vgicp()
    return m.parity.reference_vgicp_linearize(
        src, src_cov, m.parity.reference_gaussian_voxelmap(tgt, tgt_cov, 1.0), T, 1.0)


def _compute_error(m, _):
    src, src_cov, tgt, tgt_cov, T = _vgicp()
    corr = j_parity.reference_vgicp_linearize(
        src, src_cov, j_parity.reference_gaussian_voxelmap(tgt, tgt_cov, 1.0), T, 1.0)[3]
    return [m.parity.reference_compute_error(src, corr, T, dtype) for dtype in (np.float64,
                                                                                np.float32)]


def _lm_vgicp(m, _):
    src, src_cov, tgt, tgt_cov, _ = _vgicp(seed=9)
    cfg = TEST_CONFIG
    return m.parity.reference_lm_vgicp(
        src, src_cov, tgt, tgt_cov, 1.0, np.eye(4), max_iterations=cfg.vgicp_max_iterations,
        lm_max_iterations=cfg.lm_max_inner, lm_init_lambda_factor=cfg.lm_init_lambda_factor,
        rotation_epsilon=cfg.rotation_epsilon, transformation_epsilon=cfg.translation_epsilon)


def _fourdof(m, _):
    rs = np.random.RandomState(2)
    out = []
    for _ in range(10):
        yaw_i, yaw_j = rs.uniform(-180, 180, 2)
        pitch_i, roll_i = rs.uniform(-17, 17, 2)
        t_i, t_j = rs.uniform(-10, 10, (2, 3))
        out.append(m.parity.reference_fourdof_residual(
            yaw_i, t_i, yaw_j, t_j, rs.uniform(-2, 2, 3), rs.uniform(-180, 180), pitch_i, roll_i))
    return out


def _mapping_inputs():
    fx = po._mapping_fixture()
    xyzw = lambda q: np.r_[q[1:], q[0]]                                  # noqa: E731
    return fx, xyzw(fx["q0"]), xyzw(fx["ql0"])


def _mapping_associate(m, _):
    fx, q0, _ = _mapping_inputs()
    c_xyz, c_conf, s_xyz, s_conf = fx["cur"]
    return [m.parity.reference_mapping_associate(c_xyz, c_conf, q0, fx["t0"], fx["corner_map"],
                                                 "corner"),
            m.parity.reference_mapping_associate(s_xyz, s_conf, q0, fx["t0"], fx["surf_map"],
                                                 "surf")]


def _mapping_solve(m, _):
    fx, q0, ql0 = _mapping_inputs()
    return m.parity.reference_mapping_solve(
        *fx["cur"], *fx["last"], fx["corner_map"], fx["surf_map"], q0, fx["t0"], ql0, fx["tl0"],
        outer_iters=1)


def _odometry_fusion(m, _):
    plane = {"normal": np.array([0.0, 0, 1]), "v1": np.array([1.0, 0, 0]),
             "v2": np.array([0.0, 1, 0])}
    q_l = np.array([0.01, -0.02, 0.03, 1.0])
    q_l /= np.linalg.norm(q_l)
    return m.parity.reference_odometry_fusion(
        q_l, np.array([0.25, 0.1, -0.05]), 0.3,
        ground=(dict(plane, distance=0.56), dict(plane, distance=0.561),
                np.array([0.0, 0.0, 0.05, 0.99874922])),
        delta_q_imu=np.array([0.011, -0.02, 0.031, 0.99920]), imu_cov=0.4)


def _loop_icp(m, _):
    tgt = po._submap_points(21, 3072)
    src = po._drifted(po._submap_points(21, 512), 0.03, [0.3, -0.2, 0.05], seed=0)
    return m.parity.reference_loop_icp(src, tgt, 14.0)


def _rel_time(m, _):
    rng = np.random.default_rng(42)
    return [m.parity.reference_rel_time(po._sweep_xyz(720, revs, start, rng))
            for revs, start in ((1.0, 0.0), (0.97, 37.0), (1.05, 181.0))]


def _deskew(m, _):
    local = np.random.default_rng(1234)
    xyz = local.standard_normal((257, 3)) * 30.0
    intensity = local.integers(0, 16, 257) + 0.1 * local.uniform(0.0, 1.0, 257)
    outs = []
    for q in (np.array([np.cos(0.01), np.sin(0.01), 0, 0]), -np.array([np.cos(1.45), 0, 0,
                                                                        np.sin(1.45)])):
        outs.append(m.parity.reference_deskew(xyz, intensity, q, np.array([0.3, -0.1, 0.02])))
    return outs


CASES = {
    "GnssFix": lambda m, _: _fixes(m),
    "gnss_to_xyz": lambda m, _: [m.gnss.gnss_to_xyz(f, _fixes(m)[0]) for f in _fixes(m)],
    "GnssTrack": _gnss_track,
    "reference_pick": _pick,
    "reference_ground_fit": _ground_fit,
    "reference_complementary_filter": lambda m, _: m.parity.reference_complementary_filter(
        *po._imu_stream()),
    "reference_gaussian_voxelmap": lambda m, _: m.parity.reference_gaussian_voxelmap(
        *_vgicp()[2:4], 1.0),
    "reference_vgicp_linearize": _linearize,
    "reference_compute_error": _compute_error,
    "reference_lm_vgicp": _lm_vgicp,
    "reference_fourdof_residual": _fourdof,
    "reference_pgo_solve": lambda m, _: m.parity.reference_pgo_solve(*po._loop_graph()),
    "reference_mapping_associate": _mapping_associate,
    "reference_mapping_solve": _mapping_solve,
    "reference_odometry_fusion": _odometry_fusion,
    "reference_loop_icp": _loop_icp,
    "reference_rel_time": _rel_time,
    "reference_deskew": _deskew,
}


@pytest.mark.parametrize("name", list(CASES))
def test_copy_matches_original(name, tmp_path):
    port = CASES[name](PORT, tmp_path / "port")
    orig = CASES[name](JAX, tmp_path / "jax")
    _same(port, orig)


def test_copies_cover_every_public_function():
    """The same public names and signatures in each copy as in its
    original, and a case above for each public function or class."""
    covered = set()
    for kind, (port, orig) in PAIRS.items():
        public = lambda mod: {n: v for n, v in vars(mod).items()             # noqa: E731
                              if not n.startswith("_") and getattr(v, "__module__", None)
                              == mod.__name__}
        assert sorted(public(port)) == sorted(public(orig)), kind
        for name, fn in public(orig).items():
            assert inspect.signature(getattr(port, name)) == inspect.signature(fn), name
        covered |= set(public(orig))
    assert covered == set(CASES)
