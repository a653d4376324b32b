"""io/export and io/viz of the port against the JAX package's on one state.

The JAX engine maps a few scans; its ``MappingState`` and a ``LoopState``
with two stored loops are carried into the port (``bridge``).  On them
``global_map`` must select the same keyframes and points in the same order
(coordinates within 1e-5 m: the host transform rounds as XLA's does up to
float32 ulps, confidences exactly), ``loop_edges`` must give the same
segments, ``write_keyframe_pcds`` the same files, and ``write_viewer`` a
viewer of the same map, trajectory and loops.
"""
import dataclasses
import functools
import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.io import export as j_export
from rgc_slam_tpu.io import synthetic
from rgc_slam_tpu.io import viz as j_viz
from rgc_slam_tpu.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu.models import loop as j_loop
from rgc_slam_tpu.models import slam as j_slam
from rgc_slam_tpu_torch import bridge
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.io import export as t_export
from rgc_slam_tpu_torch.models.slam import SlamSystem

torch.set_num_threads(1)
XYZ_TOL = 1e-5


def _jax_state_dict(state):
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in leaves}


@pytest.fixture(scope="module")
def carried():
    """(JAX SlamState after 8 scans, JAX LoopState with loops 5->0 and
    6->1 stored, the JAX trajectory [(stamp, q, t)])."""
    seq = synthetic.generate_sequence(n_scans=9, n_azimuth=240, seed=5, extent=18.0, radius=8.0,
                                      noise=0.004, closes_loop=False, speed=4.0)
    step = jax.jit(functools.partial(j_slam.slam_step, cfg=JCFG))
    state = j_slam.SlamState.init(JCFG)
    traj = []
    for k in range(len(seq["scans"])):
        t_imu, acc, gyr = seq["imu"][k]
        state, out = step(state, cloud_from_scan_dict(seq["scans"][k], JCFG),
                          imu_from_interval(t_imu, acc, gyr, JCFG.max_imu),
                          jnp.asarray(seq["stamps"][k], jnp.float32))
        traj.append((seq["stamps"][k], np.asarray(out.q_map), np.asarray(out.t_map)))
    ls = j_loop.LoopState.init(JCFG)
    ls = ls.replace(loop_i=ls.loop_i.at[:2].set(jnp.asarray([5, 6], jnp.int32)),
                    loop_j=ls.loop_j.at[:2].set(jnp.asarray([0, 1], jnp.int32)),
                    loop_count=jnp.asarray(2, jnp.int32))
    return state, ls, traj


def _port(carried):
    state, ls, _ = carried
    return (bridge.state_from_numpy(_jax_state_dict(state), TCFG, "cpu"),
            bridge.loop_state_from_numpy(_jax_state_dict(ls), TCFG, "cpu"))


@pytest.mark.parametrize("sample_dist,density", [(0.5, 0.2), (0.0, 0.05), (2.0, 0.5)])
def test_global_map_same_points(carried, sample_dist, density):
    tstate, _ = _port(carried)
    n_kf = int(tstate.mapping.kf_count)
    assert n_kf >= 3, n_kf
    jp, jc = j_export.global_map(carried[0].mapping, JCFG, sample_dist, density)
    tp, tc = t_export.global_map(tstate.mapping, TCFG, sample_dist, density)
    assert tp.dtype == tc.dtype == np.float32 and tp.shape == jp.shape and len(tp) > 100
    assert np.abs(tp - jp).max() <= XYZ_TOL
    np.testing.assert_array_equal(tc, jc)


def test_loop_edges_and_keyframe_pcds(carried, tmp_path):
    tstate, tls = _port(carried)
    je = j_export.loop_edges(carried[0].mapping, carried[1])
    te = t_export.loop_edges(tstate.mapping, tls)
    assert te.shape == je.shape == (2, 2, 3)
    np.testing.assert_array_equal(te, je)
    t_export.write_keyframe_pcds(tstate.mapping, str(tmp_path / "t"))
    j_export.write_keyframe_pcds(carried[0].mapping, str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert len(names) == 2 * int(tstate.mapping.kf_count)
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def _data(html: str) -> dict:
    line = next(x for x in html.splitlines() if x.startswith("const DATA = "))
    return json.loads(line[len("const DATA = "):-1])


@pytest.mark.parametrize("refresh_s", [None, 2.0])
def test_write_viewer(carried, tmp_path, refresh_s):
    tstate, tls = _port(carried)
    system = SlamSystem(dataclasses.replace(TCFG, loop_cadence=5), device="cpu")
    system.state, system.loop_state, system.trajectory = tstate, tls, list(carried[2])
    from rgc_slam_tpu_torch.io.viz import write_viewer

    write_viewer(str(tmp_path / "viewer.html"), system, TCFG, refresh_s=refresh_s)
    html = (tmp_path / "viewer.html").read_text()
    assert "<canvas" in html and "const DATA" in html
    assert ('http-equiv="refresh"' in html) == (refresh_s is not None)
    jsys = types.SimpleNamespace(state=carried[0], loop_state=carried[1], trajectory=carried[2],
                                 _loop_fn=object())
    j_viz.write_viewer(str(tmp_path / "j.html"), jsys, JCFG, refresh_s=refresh_s)
    got, want = _data(html), _data((tmp_path / "j.html").read_text())
    assert (got["n_scans"], got["n_kf"], len(got["loops"]), len(got["map"])) == \
        (want["n_scans"], want["n_kf"], 2, len(want["map"]))
    assert got["traj"] == want["traj"] and got["loops"] == want["loops"]
    assert np.abs(np.asarray(got["map"]) - np.asarray(want["map"])).max() <= 1e-3 + XYZ_TOL
