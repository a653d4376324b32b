"""The port's CLI against the JAX CLI on one sweep log.

Both CLIs build their config inside ``main``; here each is made to build
TEST_CONFIG's capacities with the CLI's overrides (as tests/test_cli.py
shrinks its source), and both read the same 4-scan sweep log written by the
port's ``write_sequence``.  The port (``--device cpu``) must write every
file the JAX CLI writes, with ``pose_evo.txt`` and ``odometry_pose_evo.txt``
within 5e-3 m of the JAX CLI's (tests/test_torch_slam.py's early-scan gate).
Then ``--localize`` on the port's ``--save-ckpt`` checkpoint runs with the
map frozen: its ``global_map.pcd`` is the mapping run's, byte for byte.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import rgc_slam_tpu.config as j_config
from rgc_slam_tpu import run as j_run
from rgc_slam_tpu_torch import run as t_run
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io import synthetic
from rgc_slam_tpu_torch.io.export import read_pcd
from rgc_slam_tpu_torch.runtime.loader import write_sequence

torch.set_num_threads(1)
GATE = 5e-3
OUTPUTS = ["global_map.pcd", "metrics.jsonl", "odometry_pose_evo.txt", "pose_evo.txt",
           "timing.json", "viewer.html"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(work dir) after the JAX CLI and the port's CLI ran over the log."""
    d = tmp_path_factory.mktemp("cli")
    seq = synthetic.generate_sequence(n_scans=5, n_azimuth=120, seed=5, extent=18.0, radius=8.0,
                                      noise=0.004, closes_loop=False, speed=2.0)
    write_sequence(str(d / "seq.slog"), seq)
    flags = ["--log", str(d / "seq.slog"), "--no-loop", "--dump-frames", "--viz"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_config, "SlamConfig",
                   lambda **kw: dataclasses.replace(j_config.TEST_CONFIG, **kw))
        mp.setattr(t_run, "SlamConfig", lambda **kw: dataclasses.replace(TCFG, **kw))
        j_run.main(flags + ["--out-dir", str(d / "jax")])
        t_run.main(flags + ["--out-dir", str(d / "port"), "--device", "cpu",
                            "--save-ckpt", str(d / "ck")])
        t_run.main(["--log", str(d / "seq.slog"), "--no-loop", "--localize", str(d / "ck"),
                    "--out-dir", str(d / "loc"), "--device", "cpu"])
    return d


def test_cli_matches_jax(runs):
    port, jax_ = runs / "port", runs / "jax"
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_)) == sorted(OUTPUTS + ["frames"])
    for name in ("pose_evo.txt", "odometry_pose_evo.txt"):
        t, j = np.loadtxt(port / name), np.loadtxt(jax_ / name)
        assert t.shape == j.shape == (4, 8)
        np.testing.assert_array_equal(t[:, 0], j[:, 0])                # stamps
        assert np.abs(t[:, 1:4] - j[:, 1:4]).max() <= GATE, name
        np.testing.assert_allclose(np.linalg.norm(t[:, 4:], axis=1), 1.0, atol=1e-5)
    frames = sorted(os.listdir(port / "frames"))
    assert frames == sorted(os.listdir(jax_ / "frames")) == [f"frame_{i:06d}.pcd" for i in range(4)]
    for name in frames:
        xyz, _ = read_pcd(str(port / "frames" / name))
        xyz_j, _ = read_pcd(str(jax_ / "frames" / name))
        assert xyz.shape == xyz_j.shape and np.isfinite(xyz).all() and len(xyz) > 50
    timing = json.loads((port / "timing.json").read_text())
    assert timing.keys() == json.loads((jax_ / "timing.json").read_text()).keys() == {"scan"}
    assert timing["scan"]["count"] == 4
    rows = [json.loads(x) for x in (port / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in rows] == [["fitness", "kf_added", "n_corr", "step"]] * 4
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    html = (port / "viewer.html").read_text()
    assert "<canvas" in html and "const DATA" in html
    pts, conf = read_pcd(str(port / "global_map.pcd"))
    pts_j, _ = read_pcd(str(jax_ / "global_map.pcd"))
    assert conf is not None and np.isfinite(pts).all()
    assert abs(len(pts) - len(pts_j)) <= 0.05 * len(pts_j)


def test_cli_localize_keeps_the_map(runs):
    manifest = json.loads((runs / "ck" / "manifest.json").read_text())
    assert manifest["step"] == 4 and not manifest["loop_state"]
    loc = runs / "loc"
    assert (loc / "global_map.pcd").read_bytes() == (runs / "port" / "global_map.pcd").read_bytes()
    poses = np.loadtxt(loc / "pose_evo.txt")
    assert poses.shape == (4, 8) and np.isfinite(poses).all()
