"""``rgc_slam_tpu_torch.tools.eval_longrun.run`` cut short against the JAX
package's long-run loop (``eval_longrun.py:55-86``) run the same way.

The course is the long run's circle (``longrun_sequence``'s arguments)
driven at 0.6 m a scan instead of 0.2, so that a keyframe lands on about
every scan; the configuration is the long run's ``CFG`` with a keyframe
store of K slots, small enough that ``loop._maybe_compact`` compacts it
within the N scans.  A loop step runs every
LOOP_EVERY scans in both packages; compactions are counted where
``kf_count`` drops across a loop step.  Held: the compaction count (> 0),
the accepted loops, the final keyframe count and the loop count equal,
and the full-run ATE within PERF.md §2's rule read both ways,
|port - JAX| <= 0.05 x JAX + 0.01 m.  The cut run has no revisit, so it
accepts no loop and the long run's second assert fails, as ``check``
reports; ``main`` runs with ``--device cpu`` over 8 scans, where the first
assert fails.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgc_slam_tpu.config import SlamConfig as JConfig
from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud, imu_from_interval as j_imu
from rgc_slam_tpu.models import loop as jloop
from rgc_slam_tpu.models.slam import SlamState, slam_step
from rgc_slam_tpu.utils.evaluation import ate_rmse
from rgc_slam_tpu_torch.io import synthetic as tsyn
from rgc_slam_tpu_torch.tools import eval_longrun

torch.set_num_threads(1)
N, K = 26, 20


def _jax_longrun(cfg, seq):
    """eval_longrun.py:55-86 over ``seq``: (t_map [n, 3], accepts,
    compactions, loop count, final keyframe count)."""
    state = SlamState.init(cfg)
    lstate = jloop.LoopState.init(cfg)
    step = jax.jit(functools.partial(slam_step, cfg=cfg))
    loop_step = jax.jit(functools.partial(jloop.loop_closure_step, cfg=cfg))
    est, accepts, compactions = [], [], 0
    for k in range(len(seq["scans"])):
        t_imu, acc, gyr = seq["imu"][k]
        state, out = step(state, j_cloud(seq["scans"][k], cfg),
                          j_imu(t_imu, acc, gyr, cfg.max_imu),
                          jnp.asarray(seq["stamps"][k], jnp.float32))
        est.append(np.asarray(out.t_map))
        if (k + 1) % eval_longrun.LOOP_EVERY == 0:
            before = int(state.mapping.kf_count)
            state, lstate, info = loop_step(state, lstate)
            if int(state.mapping.kf_count) < before:
                compactions += 1
            if bool(info.accepted):
                accepts.append(k)
    return (np.stack(est), accepts, compactions, int(lstate.loop_count),
            int(state.mapping.kf_count))


def test_cut_longrun_matches_jax():
    cfg_t = dataclasses.replace(eval_longrun.CFG, max_keyframes=K)
    seq = tsyn.generate_sequence(
        n_scans=N, n_azimuth=360, seed=31, extent=26.0, radius=12.0, noise=0.004,
        motion_distortion=True, closes_loop=True, laps=N * 0.6 / (2 * np.pi * 12.0), speed=2.0)
    port = eval_longrun.run(N, cfg_t, "cpu", seq=seq)
    est, accepts, compactions, loops, kf = _jax_longrun(JConfig(**dataclasses.asdict(cfg_t)), seq)
    assert port["n_scans"] == len(est) == N - 1
    assert port["compactions"] == compactions > 0
    assert port["accepts"] == accepts and port["n_loops"] == loops
    assert port["kf_count_final"] == kf
    ref = ate_rmse(est, np.stack([t for (_, t) in seq["poses"]]))
    assert abs(port["ate_full_m"] - ref) <= 0.05 * ref + 0.01, (port["ate_full_m"], ref)
    with pytest.raises(AssertionError, match="no loop accepted after saturation"):
        eval_longrun.check(port, cfg_t)


def test_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(eval_longrun, "CFG", dataclasses.replace(eval_longrun.CFG, max_keyframes=K))
    with pytest.raises(AssertionError, match="store never compacted"):
        eval_longrun.main(["--scans", "9", "--device", "cpu"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["n_scans"] == 8 and record["device"] == "cpu" and record["compactions"] == 0
