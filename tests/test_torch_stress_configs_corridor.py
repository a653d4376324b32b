"""Off-default engine configurations through the port against JAX,
continued from tests/test_torch_stress_configs.py (same gates): the
degraded corridor under the reference's Huber loss and under
``mapping_loss="l1"``, on tests/test_stress_configs.py's inputs (all 12
scans).  tests/test_torch_stress_configs_ramp.py holds the ramp.

Condition, in both packages: the intensity-corner merge fires (a scan's
sharp/flat pick ratio under ``intensity_merge_ratio``) on the same scans,
and the JAX file's ATE bound holds.  The corridor's axis (x) is
unobserved, so it is the most sensitive scene of the suite: under 1e-7
perturbations of its scans JAX's own ATE spans 0.48-0.67 m and its poses
move by up to 0.71 m along x, and two perturbation seeds underestimate
that spread (0.67 m).  So JAX's own deviation here is taken over eight
seeds.  The gate is axis by axis, so the observed lateral and height axes
(y, z) are held to max(5e-3 m, twice JAX's own move on that axis), which
the corridor's x spread does not loosen.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

from test_torch_robustness import JCFG, TCFG, as_numpy, assert_tracks_jax
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu.ops import features as jf
from rgc_slam_tpu.utils.evaluation import ate_rmse
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict as t_cloud
from rgc_slam_tpu_torch.ops import features as tf

torch.set_num_threads(1)
SEEDS = tuple(range(1, 9))


def _drive(world, poses, dt, rng_seed, cfg, n=None):
    """tests/test_stress_configs.py's drive: one 360-azimuth scan a pose
    (the first ``n``), the IMU interval before it; returns the numpy inputs
    and raw scans."""
    imu = synthetic.synthesize_imu(poses, dt)
    rng = np.random.default_rng(rng_seed)
    scans, raw = [], []
    for k in range(len(poses) if n is None else n):
        scan = synthetic.cast_scan(world, poses[k][0], poses[k][1], n_rings=16,
                                   n_azimuth=360, rng=rng, noise=0.004)
        t_imu, acc, gyr = imu[max(k - 1, 0)]
        scans.append(as_numpy(cloud_from_scan_dict(scan, cfg),
                              imu_from_interval(t_imu, acc, gyr, cfg.max_imu), dt * (k + 1)))
        raw.append(scan)
    return scans, raw


def _merges(raw, jcfg, tcfg):
    """Per scan, whether the intensity-corner merge fires, in (JAX, the
    port): use_intensity and n_sharp / max(n_flat, 1) below the ratio."""
    def fires(sharp, flat, cfg):
        return bool(cfg.use_intensity) and sharp / max(flat, 1) < cfg.intensity_merge_ratio

    out = []
    for scan in raw:
        _, jd = jf.extract_features(cloud_from_scan_dict(scan, jcfg), jcfg, debug=True)
        _, td = tf.extract_features(t_cloud(scan, tcfg, "cpu"), tcfg, debug=True)
        out.append((fires(int(jnp.sum(jd["sharp_picked"])), int(jnp.sum(jd["flat_picked"])), jcfg),
                    fires(int(td["sharp_picked"].sum()), int(td["flat_picked"].sum()), tcfg)))
    return out


def _corridor(loss, bound):
    jcfg, tcfg = (dataclasses.replace(c, mapping_loss=loss) for c in (JCFG, TCFG))
    poses = [(np.eye(3), np.array([-20.0 + 0.25 * k, 0.0, 0.56])) for k in range(12)]
    scans, raw = _drive(synthetic.corridor_world(), poses, 0.1, 0, jcfg)
    got, ref = assert_tracks_jax(scans, jcfg, tcfg, seeds=SEEDS)[:2]
    merges = _merges(raw, jcfg, tcfg)
    assert all(j == t for j, t in merges) and any(j for j, _ in merges), merges
    gt = np.stack([t for (_, t) in poses])
    ate_port, ate_jax = ate_rmse(got, gt), ate_rmse(ref, gt)
    assert ate_port < bound and ate_jax < bound, (ate_port, ate_jax)


def test_corridor_full_slam_survives():
    _corridor("huber", 0.86)


def test_corridor_l1_loss_rescues():
    _corridor("l1", 0.26)
