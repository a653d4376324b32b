"""The torch ray caster against the numpy generator it was copied from:
noiseless sweeps and noiseless IMU windows agree."""
import numpy as np
import pytest
import torch

from rgc_slam_tpu_torch.io import synthetic
from slambench.traffic import raycast


def _traffic():
    return {"world": {"kind": "default_world", "extent": 30.0},
            "trajectory": {"radius": 24.0, "speed": 1.2, "closes_loop": False, "laps": 1.0,
                           "dt": 0.1, "height": 0.56},
            "range_noise_m": 0.0, "motion_distortion": True,
            "imu": {"rate_hz": 200.0, "gravity": 9.81, "acc_noise": 0.0, "gyr_noise": 0.0}}


@pytest.mark.parametrize("world_seed", [3, 2**31 + 11])
def test_noiseless_sweeps_match_numpy(world_seed):
    n, az = 3, 360
    traffic = _traffic()
    log = raycast.make_log(traffic, {"model": "VLP-16", "rings": 16, "azimuth": az,
                                     "max_range_m": 80.0},
                           world_seed, n, torch.Generator().manual_seed(0), "cpu", batch=2)
    seq = synthetic.generate_sequence(
        n_scans=n + 1, n_rings=16, n_azimuth=az, seed=world_seed, noise=0.0, extent=30.0,
        radius=24.0, speed=1.2, closes_loop=False, world=synthetic.default_world(
            world_seed, extent=30.0))
    for k in range(n):
        ref = seq["scans"][k]
        got = {key: v[k].numpy() for key, v in log["scans"].items()}
        np.testing.assert_array_equal(got["mask"], ref["mask"])
        np.testing.assert_array_equal(got["ring"], ref["ring"])
        np.testing.assert_array_equal(got["rel_time"], ref["rel_time"])
        m = ref["mask"]
        np.testing.assert_allclose(got["xyz"][m], ref["xyz"][m], atol=2e-5)
        # the numpy copy adds N(0, 1) to every intensity even without noise
        assert np.abs(got["intensity"][m] - ref["intensity"][m]).max() < 6.0
        assert log["stamps"][k] == pytest.approx(seq["stamps"][k])
        np.testing.assert_allclose(log["poses"][k][1], seq["poses"][k][1])


def test_noiseless_imu_matches_numpy():
    poses = synthetic.make_trajectory(6, radius=24.0, speed=1.2, closes_loop=False)
    rng_free = synthetic.synthesize_imu(poses, 0.1, acc_noise=0.0, gyr_noise=0.0)
    ours = raycast.imu_noiseless(poses, 0.1)
    for (t0, a0, g0), (t1, f, w) in zip(rng_free, ours):
        np.testing.assert_allclose(t0, t1)
        np.testing.assert_allclose(a0, np.broadcast_to(f, a0.shape).astype(np.float32),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g0, np.broadcast_to(w, g0.shape).astype(np.float32),
                                   rtol=1e-6, atol=1e-6)


def test_seed_fixes_the_log():
    traffic = {**_traffic(), "range_noise_m": 0.01,
               "imu": {"rate_hz": 200.0, "gravity": 9.81, "acc_noise": 0.02, "gyr_noise": 0.002}}
    sensor = {"model": "VLP-16", "rings": 16, "azimuth": 120, "max_range_m": 80.0}
    a, b, c = (raycast.make_log(traffic, sensor, 5, 2, torch.Generator().manual_seed(s), "cpu")
               for s in (9, 9, 10))
    assert torch.equal(a["scans"]["xyz"], b["scans"]["xyz"])
    np.testing.assert_array_equal(a["imu"][1][1], b["imu"][1][1])
    assert not torch.equal(a["scans"]["xyz"], c["scans"]["xyz"])
