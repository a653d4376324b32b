"""The port's host IO against the JAX package's on the same inputs.

``io/lz4.py``, ``io/rosbag.py``, ``runtime/loader.py`` (+ its copy of
``sweeplog.cc``), ``io/convert.py``'s channel fallbacks and ``io/viz.py``'s
``render_html`` are copies: they must give the same bytes and arrays, bit
for bit.  ``io/kitti.scan_to_cloud`` must give the same masks and rings and
bit-equal coordinates.  ``write_pcd`` / ``PcdSink`` write the same bytes,
and ``utils/profiling`` the same ``timing.json`` / ``metrics.jsonl`` JSON.
"""
import os

import numpy as np
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import convert as j_convert
from rgc_slam_tpu.io import export as j_export
from rgc_slam_tpu.io import kitti as j_kitti
from rgc_slam_tpu.io import lz4 as j_lz4
from rgc_slam_tpu.io import rosbag as j_rosbag
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io import viz as j_viz
from rgc_slam_tpu.runtime import loader as j_loader
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io import convert as t_convert
from rgc_slam_tpu_torch.io import export as t_export
from rgc_slam_tpu_torch.io import kitti as t_kitti
from rgc_slam_tpu_torch.io import lz4 as t_lz4
from rgc_slam_tpu_torch.io import rosbag as t_rosbag
from rgc_slam_tpu_torch.io import viz as t_viz
from rgc_slam_tpu_torch.runtime import loader as t_loader

torch.set_num_threads(1)


def _same_arrays(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y, err_msg=key)
        else:
            assert type(x) is type(y) and x == y, key


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_scans=4, n_azimuth=120, seed=4, extent=15.0, radius=6.0,
                                       closes_loop=False, speed=1.5)


def test_lz4_same_bytes(rng):
    payloads = [b"", bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
                b"rosbag chunk " * 9000, bytes(rng.integers(0, 4, 200_000, dtype=np.uint8))]
    for raw in payloads:
        for stored in (False, True):
            for block in (4096, 65536):
                frame = t_lz4.compress_frame(raw, stored=stored, block_size=block)
                assert frame == j_lz4.compress_frame(raw, stored=stored, block_size=block)
                assert t_lz4.decompress(frame) == j_lz4.decompress(frame) == raw


def _write_bag(mod, path, compression, with_ring, with_time):
    """The same messages through ``mod.BagWriter`` (tests/test_rosbag.py's
    layout: 100 Hz IMU, 500-point clouds, chunks of 3 messages)."""
    g = np.random.default_rng(7)
    with mod.BagWriter(path, chunk_size=3, compression=compression) as w:
        t0 = 1700000000.0
        for k in range(4):
            stamp = t0 + 0.1 * (k + 1)
            for j in range(10):
                ts = stamp - 0.1 + (j + 1) / 100
                w.write("/mynteye/imu/data_raw", "sensor_msgs/Imu", ts,
                        mod.encode_imu(ts, [0.01 * k, 0.0, 9.81], [0.0, 0.0, 0.02]))
            xyz = g.uniform(-10, 10, (500, 3)).astype(np.float32)
            xyz[:, 2] *= 0.2                              # inside a 16-beam fan
            inten = g.uniform(0, 100, 500).astype(np.float32)
            ring = g.integers(0, 16, 500).astype(np.uint16)
            rel = np.linspace(0, 0.999, 500).astype(np.float32)
            w.write("/velodyne_points", "sensor_msgs/PointCloud2", stamp,
                    mod.encode_pointcloud2(stamp, xyz, inten, ring if with_ring else None,
                                           rel if with_time else None))


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
@pytest.mark.parametrize("channels", [True, False], ids=["ring+time", "no-ring-time"])
def test_rosbag_same_bytes_and_scans(tmp_path, compression, channels):
    jp, tp = str(tmp_path / "j.bag"), str(tmp_path / "t.bag")
    _write_bag(j_rosbag, jp, compression, channels, channels)
    _write_bag(t_rosbag, tp, compression, channels, channels)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    js, ts = list(j_rosbag.scan_stream(jp)), list(t_rosbag.scan_stream(tp))
    assert len(js) == len(ts) == 4
    for a, b in zip(ts, js):
        _same_arrays(a, b)


@pytest.mark.parametrize("prefetch", [0, 4])
def test_sweeplog_same_bytes_and_scans(tmp_path, seq, prefetch):
    jp, tp = str(tmp_path / "j.slog"), str(tmp_path / "t.slog")
    j_loader.write_sequence(jp, seq)
    t_loader.write_sequence(tp, seq)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    with j_loader.SweepLogReader(jp, 2048, 32, prefetch=prefetch) as jr, \
            t_loader.SweepLogReader(tp, 2048, 32, prefetch=prefetch) as tr:
        assert (tr.n_scans, tr.n_rings) == (jr.n_scans, jr.n_rings) == (len(seq["scans"]), 16)
        js, ts = list(jr), list(tr)
    assert len(js) == len(ts) == len(seq["scans"])
    for a, b in zip(ts, js):
        _same_arrays(a, b)


def test_sweeplog_builds_into_the_port(tmp_path):
    """The port's library is its own build, under rgc_slam_tpu_torch/_build/."""
    t_loader.get_lib()
    assert t_loader.LIBRARY.endswith(os.path.join("rgc_slam_tpu_torch", "_build", "libsweeplog.so"))
    assert os.path.exists(t_loader.LIBRARY)
    maps = open("/proc/self/maps").read()
    assert t_loader.LIBRARY in maps


def test_pcd_sink_and_write_pcd_same_bytes(tmp_path, rng):
    frames = [rng.normal(0, 5, (n, 3)).astype(np.float32) for n in (300, 0, 1200)]
    for mod, d in ((t_loader, tmp_path / "t"), (j_loader, tmp_path / "j")):
        sink = mod.PcdSink(str(d))
        for i, xyz in enumerate(frames):
            sink.push(i, xyz)
        assert sink.close() == 0                  # drained, no write errors
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [f"frame_{i:06d}.pcd" for i in range(3)]
    for name, xyz in zip(names, frames):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
        back, inten = t_export.read_pcd(str(tmp_path / "t" / name))
        np.testing.assert_array_equal(back, xyz)
        assert inten is None
    xyz, inten = frames[2], rng.uniform(0, 1, 1200).astype(np.float32)
    for it in (None, inten):
        t_export.write_pcd(str(tmp_path / "t.pcd"), xyz, it)
        j_export.write_pcd(str(tmp_path / "j.pcd"), xyz, it)
        assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
        back, bi = t_export.read_pcd(str(tmp_path / "t.pcd"))
        np.testing.assert_array_equal(back, xyz)
        assert (bi is None) == (it is None)


@pytest.mark.parametrize("n_scans", [16, 32, 64])
def test_channel_fallbacks_same_arrays(rng, n_scans):
    az = np.linspace(0, 2 * np.pi, 3000, endpoint=False) + 0.3
    elev = np.radians(rng.uniform(-26, 4, 3000))
    r = rng.uniform(2, 40, 3000)
    xyz = np.stack([r * np.cos(elev) * np.cos(az), -r * np.cos(elev) * np.sin(az),
                    r * np.sin(elev)], 1).astype(np.float32)
    for a, b in zip(t_convert.ring_from_vertical_angle(xyz, n_scans),
                    j_convert.ring_from_vertical_angle(xyz, n_scans)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    a, b = t_convert.rel_time_from_azimuth(xyz), j_convert.rel_time_from_azimuth(xyz)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_kitti_scan_to_cloud(tmp_path):
    """64-beam scans as KITTI .bin files: masks and rings exactly, xyz and
    every other channel bit-equal."""
    import dataclasses

    world = synthetic.default_world(3, extent=18.0)
    g = np.random.default_rng(0)
    scan = synthetic.cast_scan(world, np.eye(3), np.array([0.3, 0.0, 1.73]), n_rings=64,
                               n_azimuth=240, rng=g, noise=0.005)
    m = scan["mask"]
    raw = np.concatenate([scan["xyz"][m], (scan["intensity"][m] / 255.0)[:, None]], 1)
    raw.astype(np.float32).tofile(tmp_path / "000000.bin")
    raw = t_kitti.read_velodyne_bin(str(tmp_path / "000000.bin"))
    np.testing.assert_array_equal(raw, j_kitti.read_velodyne_bin(str(tmp_path / "000000.bin")))
    kw = dict(n_scans=64, use_imu=False, use_ground=False, lidar_height=1.73, max_points=16384)
    jc = j_kitti.scan_to_cloud(raw, dataclasses.replace(JCFG, **kw))
    tc = t_kitti.scan_to_cloud(raw, dataclasses.replace(TCFG, **kw), "cpu")
    for f in ("xyz", "intensity", "rel_time", "ring", "mask"):
        a, b = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(tc.mask.sum()) > 1000
    seq = t_kitti.KittiSequence(str(tmp_path), dataclasses.replace(TCFG, **kw), device="cpu")
    (item,) = list(seq)
    assert item["stamp"] == 0.1 and not bool(item["imu"].mask.any())
    np.testing.assert_array_equal(item["cloud"].xyz.numpy(), tc.xyz.numpy())


def test_render_html_same_string(rng):
    traj = np.cumsum(rng.normal(0, 0.3, (20, 3)), 0)
    pts = rng.normal(0, 8, (5000, 3))
    edges = [(traj[2], traj[15]), (traj[4], traj[18])]
    for kw in (dict(), dict(refresh_s=2.0, max_points=1000, n_kf=7)):
        assert t_viz.render_html(traj, pts, edges, **kw) == j_viz.render_html(traj, pts, edges, **kw)
    assert t_viz.render_html(np.zeros((0, 3)), np.zeros((0, 3))) == \
        j_viz.render_html(np.zeros((0, 3)), np.zeros((0, 3)))


def test_profiling_same_json(tmp_path):
    """StageTimer.summary and Metrics.dump write the JAX module's JSON;
    trace writes a Chrome trace of the block."""
    import json

    from rgc_slam_tpu.utils import profiling as j_prof
    from rgc_slam_tpu_torch.utils import profiling as t_prof

    samples = [12.5, 180.25, 99.0, 101.5, 7.0]
    timers = (t_prof.StageTimer(budget_ms=100.0), j_prof.StageTimer(budget_ms=100.0))
    for timer in timers:
        timer.samples["scan"].extend(samples)
        with timer.stage("io"):
            pass
    a, b = (t.summary() for t in timers)
    assert a["scan"] == b["scan"] and a.keys() == b.keys() == {"scan", "io"}
    assert a["io"]["count"] == b["io"]["count"] == 1
    for mod, name in ((t_prof, "t.jsonl"), (j_prof, "j.jsonl")):
        m = mod.Metrics()
        m.log(0, fitness=np.float32(0.25), n_corr=310, kf_added=True)
        m.log(1, fitness=0.5, n_corr=np.int32(7), kf_added=False)
        m.dump(str(tmp_path / name))
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    with t_prof.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
