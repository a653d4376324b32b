"""``registration.lm_register`` of the port on tests/test_registration.py's
scan pair: two 360-azimuth scans of ``default_world(1)`` 6 cm of yaw and
27 cm apart.

The registration inputs (the scans' features downsampled with their
covariances, the target's Gaussian voxel map) are built once by the JAX
package as tests/test_registration.py builds them and handed to both
packages' ``lm_register``.  Each case must meet the JAX test's gate on the
port's result, and the port's pose must lie within 1e-4 of JAX's
(tests/test_torch_registration.py's final-pose gate):

* from the identity (test_registration.py:49): rotation within 0.5 deg
  and translation within 0.05 m of the truth, more than 200
  correspondences;
* a scan against itself from the identity (:77): it stays within 0.02 m
  and |q_w| > 0.99999;
* from a poor guess, 7 deg of yaw and 0.45 m off (:90): within 0.1 m of
  the truth.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.ops import registration as jreg
from rgc_slam_tpu.ops import voxelhash as jvh
from rgc_slam_tpu.utils import math3d as jm3
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.ops import registration as treg
from rgc_slam_tpu_torch.types import VoxelMap
from rgc_slam_tpu_torch.utils import math3d as tm3
from test_registration import CFG as JCFG, _downsample_with_covs, _prep, pair  # noqa: F401

torch.set_num_threads(1)

CASES = {
    "recovers the pose": ("b", [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
    "identity stays put": ("a", [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
    "converges from a bad guess": ("b", [0.12, 0.0, 0.0], [0.4, -0.2, 0.0]),
}


@pytest.fixture(scope="module")
def inputs(pair):
    sa, sb, R_ab, t_ab = pair
    fa, fb = _prep(sa), _prep(sb)
    tgt, tgt_cov, tgt_mask = _downsample_with_covs(fa, JCFG.target_voxel_size, 4096)
    vm = jvh.build_gaussian_voxelmap(tgt, tgt_cov, tgt_mask, JCFG.vgicp_resolution,
                                     JCFG.max_voxels)
    sources = {name: _downsample_with_covs(f, JCFG.source_voxel_size, JCFG.max_source_points)
               for name, f in (("a", fa), ("b", fb))}
    return vm, sources, R_ab, t_ab


@pytest.mark.parametrize("case", list(CASES))
def test_lm_register_on_the_scan_pair(inputs, case):
    vm, sources, R_ab, t_ab = inputs
    which, ypr0, t0 = CASES[case]
    src, src_cov, src_mask = sources[which]
    q0 = np.array(jm3.ypr_to_quat(jnp.asarray(ypr0, jnp.float32)))
    t0 = np.asarray(t0, np.float32)
    jres = jax.jit(functools.partial(jreg.lm_register, cfg=JCFG))(
        src, src_cov, src_mask, vm, jnp.asarray(q0), jnp.asarray(t0))
    tvm = VoxelMap(**{f: torch.from_numpy(np.array(getattr(vm, f)))
                      for f in ("keys", "mean", "cov", "num_points", "resolution")})
    res = treg.lm_register(*(torch.from_numpy(np.array(x)) for x in (src, src_cov, src_mask)),
                           tvm, torch.from_numpy(q0), torch.from_numpy(t0), TCFG)
    q, t = res.q.numpy(), res.t.numpy()
    if case == "recovers the pose":
        R = tm3.quat_to_mat(res.q).numpy()
        rot_err = np.degrees(np.arccos(np.clip((np.trace(R.T @ R_ab) - 1) / 2, -1, 1)))
        assert int(res.n_corr) > 200
        assert rot_err < 0.5, rot_err
        assert np.linalg.norm(t - t_ab) < 0.05
    elif case == "identity stays put":
        assert np.linalg.norm(t) < 0.02 and abs(float(q[0])) > 0.99999
    else:
        assert np.linalg.norm(t - t_ab) < 0.1
    np.testing.assert_allclose(t, np.asarray(jres.t), atol=1e-4, rtol=0)
    jq = np.asarray(jres.q)
    assert min(np.abs(q - jq).max(), np.abs(q + jq).max()) <= 1e-4, (q, jq)
    assert int(res.n_corr) == int(jres.n_corr)
