"""The port's copies of the numpy-only modules against the JAX package's files.

``rgc_slam_tpu_torch/io/synthetic.py`` and ``utils/evaluation.py`` are
copies, so that the port imports nothing of the JAX package.  They must give
the same arrays, numbers and bytes as the originals on the same arguments.
"""
import dataclasses

import numpy as np
import pytest

from rgc_slam_tpu.io import synthetic as j_synthetic
from rgc_slam_tpu.utils import evaluation as j_evaluation
from rgc_slam_tpu_torch.io import synthetic as t_synthetic
from rgc_slam_tpu_torch.utils import evaluation as t_evaluation

# chip_smoke.py's main-path sequence and one of its fleet worlds (whose JAX
# numbers chip_smoke_reference.py computes with the original), and
# tests/test_torch_slam.py's
SEQUENCES = {
    "chip_smoke": dict(n_scans=16, n_azimuth=1800, seed=5, extent=18.0, radius=8.0, noise=0.004,
                       motion_distortion=True, closes_loop=False, speed=2.0),
    "chip_smoke_fleet": dict(n_scans=13, n_azimuth=900, seed=8, extent=30.0, radius=12.0,
                             noise=0.01, closes_loop=False, speed=2.0),
    "test_slam": dict(n_scans=31, n_azimuth=360, seed=5, extent=18.0, radius=8.0, noise=0.004,
                      motion_distortion=True, closes_loop=False, speed=2.0),
}


def _assert_same(a, b, path="seq"):
    """Equal structure, equal dtypes, bit-equal arrays."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        _assert_same(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for key in a:
            _assert_same(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_generate_sequence_same_arrays(name):
    args = SEQUENCES[name]
    _assert_same(t_synthetic.generate_sequence(**args), j_synthetic.generate_sequence(**args))


def test_evaluation_same_numbers_and_bytes(rng, tmp_path):
    gt = np.cumsum(rng.normal(0.0, 0.2, (40, 3)), axis=0)
    est = gt + rng.normal(0.0, 0.05, gt.shape)
    yaw = 0.3
    rot = np.array([[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0], [0, 0, 1]])
    est = est @ rot.T + np.array([1.0, -2.0, 0.5])
    for align in (True, False):
        assert t_evaluation.ate_rmse(est, gt, align) == j_evaluation.ate_rmse(est, gt, align)
    for delta in (1, 5):
        assert t_evaluation.rpe_rmse(est, gt, delta) == j_evaluation.rpe_rmse(est, gt, delta)
    for r_t, r_j in zip(t_evaluation.umeyama_alignment(est, gt, with_scale=True),
                        j_evaluation.umeyama_alignment(est, gt, with_scale=True)):
        np.testing.assert_array_equal(r_t, r_j)

    stamps = np.arange(40) * 0.1
    quats = rng.normal(size=(40, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    t_evaluation.dump_tum(str(tmp_path / "port.txt"), stamps, est, quats)
    j_evaluation.dump_tum(str(tmp_path / "jax.txt"), stamps, est, quats)
    port_bytes = (tmp_path / "port.txt").read_bytes()
    assert port_bytes == (tmp_path / "jax.txt").read_bytes()
    assert port_bytes.count(b"\n") == 40
