"""The keyframe store's eviction over a long drive without loops, through
the port: tests/test_mapping.py:115 (``test_eviction_no_loop_long_run``).

TEST_CONFIG with loops off, ``max_keyframes=16`` and ``keyframe_dist=0.1``
over the JAX test's 43-scan straight drive (~44 keyframe adds against a
capacity of 16).  The JAX test's invariants on the port's run: the store
never exceeds its capacity and still holds more than 8 keyframes at the
end (compaction ran instead of freezing), the newest keyframe lies within
0.5 m of the robot, the travel accumulators stay monotone across the
compactions, and the trajectory ATE stays under 0.25 m.  The unit of
compaction is held to JAX's by tests/test_torch_mapping.py.
"""
import dataclasses

import numpy as np
import torch

from rgc_slam_tpu_torch.config import TEST_CONFIG
from rgc_slam_tpu_torch.io import synthetic
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu_torch.models.slam import SlamState, slam_step
from rgc_slam_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(1)


def test_eviction_no_loop_long_run():
    cfg = dataclasses.replace(TEST_CONFIG, loop_closure_enable=False, max_keyframes=16,
                              keyframe_dist=0.1)
    seq = synthetic.generate_sequence(n_scans=44, n_azimuth=240, seed=5, extent=18.0,
                                      radius=8.0, noise=0.004, closes_loop=False, speed=2.0)
    state = SlamState.init(cfg, "cpu")
    est, counts = [], []
    for k, scan in enumerate(seq["scans"]):
        t_imu, acc, gyr = seq["imu"][k]
        state, out = slam_step(state, cloud_from_scan_dict(scan, cfg, "cpu"),
                               imu_from_interval(t_imu, acc, gyr, cfg.max_imu, "cpu"),
                               torch.tensor(seq["stamps"][k], dtype=torch.float32), cfg)
        est.append(out.t_map.numpy())
        counts.append(int(state.mapping.kf_count))
    assert max(counts) <= 16
    assert counts[-1] > 8
    kf_t = state.mapping.kf_t.numpy()[: counts[-1]]
    assert np.linalg.norm(kf_t[-1] - est[-1]) < 0.5
    tr = state.mapping.kf_travel.numpy()[: counts[-1]]
    assert (np.diff(tr) > 0).all()
    gt = np.stack([t for (_, t) in seq["poses"]])
    ate = ate_rmse(np.stack(est), gt)
    assert ate < 0.25, f"ATE {ate:.3f} m across compactions"
