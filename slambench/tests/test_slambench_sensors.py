"""A second sensor through the harness: the HDL-64E's ring table, street
worlds and drives, sweeps without a ring channel and without IMU, and a
reference that follows ``use_ground``.

    python3 -m pytest -q slambench/tests/test_slambench_sensors.py
"""
import json
import math

import numpy as np
import pytest
import torch

from rgc_slam_tpu_torch.io.convert import ring_from_vertical_angle
from rgc_slam_tpu_torch.io.kitti import scan_to_cloud
from slambench import run
from slambench.drivers import slam_system
from slambench.record import Spans
from slambench.reference import compare
from slambench.tests import sensor_runs, tiny
from slambench.traffic import raycast, streets

CELL = sensor_runs.CELL
HDL64 = {"model": "HDL-64E", "rings": 64, "azimuth": 240, "max_range_m": 40.0}
VLP16_TRAFFIC = {"world": {"kind": "default_world", "extent": 30.0},
                 "trajectory": {"radius": 24.0, "speed": 1.2, "closes_loop": False, "laps": 1.0,
                                "dt": 0.1, "height": 0.56},
                 "range_noise_m": 0.01, "motion_distortion": True,
                 "imu": {"rate_hz": 200.0, "gravity": 9.81, "acc_noise": 0.02,
                         "gyr_noise": 0.002}}
# the trial cell's city: 80 m blocks, 14 m streets, legs of two blocks
CITY = {**sensor_runs.STREETS,
        "world": {**sensor_runs.STREETS["world"], "block_m": 80.0, "street_m": 14.0,
                  "margin_m": 125.0},
        "trajectory": {**sensor_runs.STREETS["trajectory"], "leg_blocks": 2,
                       "turn_radius_m": 7.0}}


def _cell():
    _, spec, traffic, _ = run.cell(tiny.bench(), CELL)
    return spec, traffic


def test_ring_tables():
    vlp = raycast.ring_elevations_deg({"model": "VLP-16", "rings": 16})
    np.testing.assert_array_equal(vlp, -15.0 + 2.0 * np.arange(16))
    hdl = raycast.ring_elevations_deg({"model": "HDL-64E", "rings": 64})
    assert hdl.shape == (64,) and hdl[0] == 2.0 and hdl[32] == -8.83
    np.testing.assert_allclose(hdl[31], 2.0 - 31 / 3)
    np.testing.assert_allclose(hdl[63], -24.33)
    assert (np.diff(hdl) < 0).all()                       # ring 0 the highest
    with pytest.raises(ValueError, match="no ring table"):
        raycast.ring_elevations_deg({"model": "HDL-32E", "rings": 32})
    with pytest.raises(ValueError, match="has 64 rings"):
        raycast.ring_elevations_deg({"model": "HDL-64E", "rings": 16})


@pytest.mark.parametrize("azimuth", [240, 2083])
def test_hdl64_rings_recovered_by_the_port(azimuth):
    world, poses = raycast.world_and_path(sensor_runs.STREETS, 7, 3)
    sensor = {**HDL64, "azimuth": azimuth}
    s = raycast.cast_sweeps(raycast.within(world, poses, 40.0), poses, 0, 2, sensor, 0.02,
                            torch.Generator().manual_seed(3), "cpu")
    for k in range(2):
        m = s["mask"][k].numpy()
        cast = s["ring"][k].numpy()[m]
        ring, valid = ring_from_vertical_angle(s["xyz"][k].numpy()[m], 64)
        assert m.mean() > 0.5
        np.testing.assert_array_equal(ring, cast)
        np.testing.assert_array_equal(valid, cast <= 50)   # the source keeps rings 0-50
        assert set(np.unique(cast)) == set(range(64))


def test_culling_changes_no_return():
    """A street batch cast against the primitives within reach returns
    what the whole grid returns; only masked entries may differ."""
    world, poses = raycast.world_and_path(sensor_runs.STREETS, 11, 4)
    sensor = {**HDL64, "azimuth": 120}
    a, b = (raycast.cast_sweeps(w, poses, 0, 4, sensor, 0.02, torch.Generator().manual_seed(5),
                                "cpu")
            for w in (world, raycast.within(world, poses, sensor["max_range_m"])))
    assert len(raycast.within(world, poses, 40.0).boxes) < len(world.boxes)
    assert torch.equal(a["mask"], b["mask"])
    m = a["mask"]
    for k in ("xyz", "intensity"):
        assert torch.equal(a[k][m], b[k][m])


def _gate_pairs(poses):
    """Pairs (i, j) of poses that the port's loop search would take as a
    candidate (models/loop.py): travel apart over 20 + r and distance
    under r, r = 15 + 0.02 x the travel since the last loop (none)."""
    xy = np.stack([t for _, t in poses])[:, :2]
    travel = np.concatenate([[0.0], np.cumsum(np.hypot(*np.diff(xy, axis=0).T))])
    r = 15.0 + 0.02 * travel
    d = np.hypot(*(xy[:, None, :] - xy[None, :, :]).transpose(2, 0, 1))
    apart = np.abs(travel[:, None] - travel[None, :])
    return np.argwhere((apart > 20.0 + r[:, None]) & (d < r[:, None])), d, apart


@pytest.mark.parametrize("traffic", [sensor_runs.STREETS, CITY], ids=["tiny", "city"])
def test_street_drive_passes_no_loop_gate(traffic):
    n = 2000                                    # 1.6 km at 0.8 m a scan
    world, poses = raycast.world_and_path(traffic, 3, n)
    pairs, d, apart = _gate_pairs(poses)
    assert len(pairs) == 0, pairs[:5]
    far = apart > 1.0
    assert (d[far] / apart[far]).min() >= 1 / math.sqrt(2) - 1e-9   # a monotone staircase
    xy = np.stack([t for _, t in poses])[:, :2]
    for b in world.boxes:                       # nothing on the lane (clear_path's margin)
        gap = np.hypot(xy[:, 0] - np.clip(xy[:, 0], b[0], b[3]),
                       xy[:, 1] - np.clip(xy[:, 1], b[1], b[4]))
        assert gap.min() > 2.0
    for c in world.cylinders:
        assert (np.hypot(xy[:, 0] - c[0], xy[:, 1] - c[1]) - c[2]).min() > 2.0
    assert len(world.boxes) > 100 and len(world.cylinders) > 100


def test_street_drive_turns_in_a_staircase():
    traffic = sensor_runs.STREETS
    segs = streets.drive_segments(traffic["world"], traffic["trajectory"], 1000.0)
    signs = [s[4] for s in segs if s[0] == "arc"]
    assert signs[:4] == [1.0, -1.0, 1.0, -1.0]   # left, right, left, right
    heads = [tuple(s[2]) for s in segs if s[0] == "line"]
    assert heads[:3] == [(1.0, 0.0), (0.0, 1.0), (1.0, 0.0)]


def test_log_without_imu():
    """No ``imu`` entry: no IMU windows, and the sweeps the generator gave
    before, since the IMU is drawn after them."""
    sensor = {"model": "VLP-16", "rings": 16, "azimuth": 120, "max_range_m": 80.0}
    without = {k: v for k, v in VLP16_TRAFFIC.items() if k != "imu"}
    a, b = (raycast.make_log(t, sensor, 5, 3, torch.Generator().manual_seed(9), "cpu")
            for t in (VLP16_TRAFFIC, without))
    assert b["imu"] is None and len(a["imu"]) == 3
    for k in a["scans"]:
        assert torch.equal(a["scans"][k], b["scans"][k])


def test_settings_refuse_ground_off_the_vlp16():
    spec, _ = _cell()
    cfg = spec["slam_config"]
    assert compare.settings(cfg)["use_ground"]
    with pytest.raises(ValueError, match="use_ground true needs n_scans 16"):
        compare.settings({**cfg, "n_scans": 64})
    assert not compare.settings({**cfg, "n_scans": 64, "use_ground": False})["use_ground"]


def test_driver_refuses_imu_without_imu_traffic():
    spec, traffic = _cell()
    spec = sensor_runs.kitti_spec(spec)
    spec["slam_config"]["use_imu"] = True
    with pytest.raises(ValueError, match="uses the IMU and the traffic draws none"):
        slam_system.Driver(spec, sensor_runs.kitti_traffic(traffic), 1, "cpu", Spans(), {})


@pytest.fixture(scope="module")
def kitti_driver():
    """The tiny 64-ring cell's driver after its warm-up and three window
    calls, each call's cloud and IMU as ``SlamSystem.process`` got them."""
    spec, traffic = _cell()
    spec = sensor_runs.kitti_spec(spec)
    traffic = {**sensor_runs.kitti_traffic(traffic), "log_scans": 8}
    driver = slam_system.Driver(spec, traffic, tiny.SEED, "cpu", Spans(), {})
    handed = {}
    process = driver.system.process

    def recording(cloud, imu, stamp):
        handed[driver.next] = (cloud, imu)
        return process(cloud, imu, stamp)

    driver.system.process = recording
    driver.sample(tiny.SEED)
    for _ in range(3):
        driver.step_call()
    driver.stop_sampling()
    cfg = driver.cfg
    driver.release()
    return driver, cfg, handed, spec, traffic


def test_ringless_feed_is_the_ports_kitti_path(kitti_driver):
    driver, cfg, handed, spec, traffic = kitti_driver
    log = raycast.make_log(traffic, spec["sensor"],
                           raycast.world_seeds(tiny.SEED, 1)[0], traffic["log_scans"],
                           torch.Generator().manual_seed(tiny.SEED), "cpu")
    host = {k: v.numpy() for k, v in log["scans"].items()}
    assert len(handed) == 3
    for i, (cloud, imu) in handed.items():
        raw = driver.scans[i]
        m = host["mask"][i]
        assert raw.dtype == np.float32 and raw.shape == (m.sum(), 4)
        np.testing.assert_array_equal(raw[:, :3], host["xyz"][i][m])   # returns, ring-major
        np.testing.assert_array_equal(raw[:, 3], (host["intensity"][i][m] / 255.0)
                                      .astype(np.float32))
        assert 0.0 <= raw[:, 3].min() and raw[:, 3].max() <= 1.0
        want = scan_to_cloud(raw, cfg, "cpu")
        for f in ("xyz", "intensity", "rel_time", "ring", "mask"):
            assert torch.equal(getattr(cloud, f), getattr(want, f)), f
        assert not imu.mask.any() and imu.t.shape == (cfg.max_imu,)
        assert not imu.acc.any() and not imu.gyr.any()


def test_reference_without_ground(kitti_driver):
    driver = kitti_driver[0]
    cfg = driver.ref_cfg
    assert cfg["n_scans"] == 64 and not cfg["use_ground"] and not cfg["use_imu"]
    rows, stand_ins = [], []
    for call in driver.calls():
        assert call["imu"] is None and call["scan"].shape[1] == 4
        ref = compare.reference(call, cfg, "float64")
        assert ref["ground"] is None
        rows.append(compare.row(call, ref, cfg))
        stand_ins.append(compare.stand_in_row(call, compare.reference(call, cfg, "float32"), ref,
                                              cfg))
    assert len(rows) >= 3
    for r in rows + stand_ins:
        assert r["ground_dist_m"] is None and r["ground_angle_rad"] is None
        assert math.isfinite(r["map_pos_m"]) and math.isfinite(r["map_rot_rad"])
    numbers = compare.summary(rows)
    assert "ground_dist_max_m" not in numbers
    line = json.loads(json.dumps({k: numbers[k] for k in compare.DIAGNOSTIC}))
    assert line["ground_dist_max_m"] is None and line["ground_angle_max_rad"] is None
    assert all(math.isfinite(numbers[k]) for k in compare.NUMBERS)
    assert compare.failed_calls(rows, numbers, {"map_pos_med_m": 1.0, "map_rot_med_rad": 1.0,
                                                "keyframe_mismatch": 0}) == 0
