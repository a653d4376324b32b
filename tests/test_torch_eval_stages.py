"""``rgc_slam_tpu_torch.tools.eval_stages`` on the CPU and against JAX.

* The variant configurations of ``fleet_differential`` (the full fleet
  step, mapping skipped, mapping skipped with the VGICP LM capped at one
  iteration), taken from a small configuration, run through the port's
  ``fleet_step`` at B=2 over 3 scans of two worlds and through the JAX
  package's jitted ``fleet_step`` on the same inputs: each robot's
  ``t_map`` within 5e-3 m of JAX's at every scan (PERF.md §2's floor for
  a few scans), and the keyframe counts equal.
* On the CPU: tests/test_torch_eval_stages_cpu.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgc_slam_tpu.config import SlamConfig as JConfig
from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud, imu_from_interval as j_imu
from rgc_slam_tpu.parallel import fleet as jfleet
from rgc_slam_tpu_torch import config as tcfg
from rgc_slam_tpu_torch.io import synthetic as tsyn
from rgc_slam_tpu_torch.parallel import fleet as tfleet
from rgc_slam_tpu_torch.tools import eval as teval
from rgc_slam_tpu_torch.tools import eval_stages
from rgc_slam_tpu_torch.types import tree_stack

torch.set_num_threads(1)
SMALL = dataclasses.replace(tcfg.TEST_CONFIG, inline_compaction=False)
GATE = 5e-3


def _seqs():
    return [tsyn.generate_sequence(n_scans=4, n_azimuth=120, seed=s, extent=18.0, radius=8.0,
                                   noise=0.004, closes_loop=False, speed=2.0) for s in (1, 2)]


@pytest.mark.parametrize("variant", list(eval_stages.variant_configs(SMALL)))
def test_variants_match_jax(variant):
    seqs = _seqs()
    cfg_t = eval_stages.variant_configs(SMALL)[variant]
    cfg_j = JConfig(**dataclasses.asdict(cfg_t))
    jstep = jax.jit(functools.partial(jfleet.fleet_step, cfg=cfg_j))
    st_j, st_t = jfleet.fleet_init(cfg_j, 2), tfleet.fleet_init(cfg_t, 2, "cpu")
    for k in range(3):
        lanes = []
        for sq in seqs:
            ti, a, g = sq["imu"][k]
            lanes.append((j_cloud(sq["scans"][k], cfg_j), j_imu(ti, a, g, cfg_j.max_imu),
                          jnp.asarray(sq["stamps"][k], jnp.float32)))
        batch = [jax.tree.map(lambda *x: jnp.stack(x), *[lane[j] for lane in lanes])
                 for j in range(3)]
        st_j, out_j = jstep(st_j, *batch)
        tbatch = [tree_stack(x) for x in zip(*(teval.scan_inputs(sq, k, cfg_t, "cpu")
                                               for sq in seqs))]
        st_t, out_t = tfleet.fleet_step(st_t, *tbatch, cfg_t)
        err = np.abs(out_t.t_map.numpy() - np.asarray(out_j.t_map)).max()
        assert err <= GATE, (variant, k, err)
        assert np.array_equal(st_t.mapping.kf_count.numpy(), np.asarray(st_j.mapping.kf_count))
