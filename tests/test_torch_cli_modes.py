"""The port's CLI over its other sources and options, on the CPU.

The CLI is made to build TEST_CONFIG's capacities (with its overrides) and
the synthetic source to cast 120-azimuth sweeps, as tests/test_cli.py does
for the JAX CLI.  Each run must write finite unit poses for every scan:
``--chunk 2`` over an odd scan count (the trajectory byte-equal to the
unchunked run's), ``--bag`` (an lz4-chunked bag written with the port's
``BagWriter`` by chip_smoke.py's ``write_bag``, as phase 7 writes its
bag), ``--kitti`` over two ``.bin`` files, ``--synthetic`` with
``--imu-cov-mode preint`` and ``--viz-every``.  Fleet-only rejections and
the default device without CUDA fail loudly.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import write_bag
from rgc_slam_tpu_torch import run as t_run
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io import kitti, synthetic
from rgc_slam_tpu_torch.runtime.loader import write_sequence

torch.set_num_threads(1)


@pytest.fixture()
def small(monkeypatch):
    monkeypatch.setattr(t_run, "SlamConfig", lambda **kw: dataclasses.replace(TCFG, **kw))
    orig = synthetic.generate_sequence
    monkeypatch.setattr(synthetic, "generate_sequence", lambda **kw: orig(**dict(kw, n_azimuth=120)))


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_scans=4, n_azimuth=120, seed=5, extent=18.0, radius=8.0,
                                       noise=0.004, closes_loop=False, speed=2.0)


def _poses(out, n):
    p = np.loadtxt(out / "pose_evo.txt")
    assert p.shape == (n, 8) and np.isfinite(p).all()
    np.testing.assert_allclose(np.linalg.norm(p[:, 4:], axis=1), 1.0, atol=1e-5)
    return p


def test_cli_chunk_over_odd_count(small, seq, tmp_path):
    write_sequence(str(tmp_path / "s.slog"), seq)
    base = ["--log", str(tmp_path / "s.slog"), "--no-loop", "--device", "cpu"]
    t_run.main(base + ["--out-dir", str(tmp_path / "c2"), "--chunk", "2"])
    t_run.main(base + ["--out-dir", str(tmp_path / "c1")])
    _poses(tmp_path / "c2", 3)
    for name in ("pose_evo.txt", "odometry_pose_evo.txt"):
        assert (tmp_path / "c2" / name).read_bytes() == (tmp_path / "c1" / name).read_bytes()
    timing = json.loads((tmp_path / "c2" / "timing.json").read_text())
    assert timing["scan"]["count"] == 2                 # one chunk of 2, then 1 scan alone


def test_cli_bag(small, seq, tmp_path):
    write_bag(str(tmp_path / "s.bag"), seq)
    t_run.main(["--bag", str(tmp_path / "s.bag"), "--no-loop", "--device", "cpu",
                "--out-dir", str(tmp_path / "out")])
    p = _poses(tmp_path / "out", 3)
    np.testing.assert_allclose(p[:, 0], seq["stamps"], atol=1e-6)
    assert (tmp_path / "out" / "global_map.pcd").exists()


def test_cli_kitti(monkeypatch, tmp_path):
    monkeypatch.setattr(kitti, "kitti_config", lambda **kw: dataclasses.replace(
        TCFG, **dict(kitti.KITTI_CONFIG_OVERRIDES, max_points=16384), **kw))
    world = synthetic.default_world(3, extent=18.0)
    g = np.random.default_rng(0)
    vdir = tmp_path / "velodyne"
    vdir.mkdir()
    for k in range(2):
        scan = synthetic.cast_scan(world, np.eye(3), np.array([0.3 * k, 0.0, 1.73]), n_rings=64,
                                   n_azimuth=240, rng=g, noise=0.005)
        m = scan["mask"]
        np.concatenate([scan["xyz"][m], (scan["intensity"][m] / 255.0)[:, None]],
                       1).astype(np.float32).tofile(vdir / f"{k:06d}.bin")
    t_run.main(["--kitti", str(vdir), "--no-loop", "--device", "cpu",
                "--out-dir", str(tmp_path / "out")])
    p = _poses(tmp_path / "out", 2)
    np.testing.assert_allclose(p[:, 0], [0.1, 0.2])


def test_cli_synthetic_preint_viz_every(small, tmp_path):
    out = tmp_path / "out"
    t_run.main(["--synthetic", "3", "--no-loop", "--imu-cov-mode", "preint", "--viz-every", "2",
                "--device", "cpu", "--out-dir", str(out)])
    _poses(out, 3)
    html = (out / "viewer.html").read_text()
    assert "<canvas" in html and 'http-equiv="refresh"' not in html     # final, static viewer
    assert sorted(os.listdir(out)) == ["global_map.pcd", "metrics.jsonl", "odometry_pose_evo.txt",
                                       "pose_evo.txt", "timing.json", "viewer.html"]


@pytest.mark.parametrize("flag", [["--dump-frames"], ["--viz"], ["--viz-every", "2"],
                                  ["--save-ckpt", "CK"], ["--localize", "CK"]],
                         ids=lambda f: f[0])
def test_cli_fleet_rejects_flag(small, tmp_path, flag):
    flag = [str(tmp_path / "ck") if x == "CK" else x for x in flag]
    with pytest.raises(SystemExit, match=flag[0]):
        t_run.main(["--synthetic", "2", "--fleet", "2", "--device", "cpu",
                    "--out-dir", str(tmp_path / "x")] + flag)


def test_cli_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default cannot fail here")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_run.main(["--synthetic", "2", "--out-dir", str(tmp_path / "x")])
