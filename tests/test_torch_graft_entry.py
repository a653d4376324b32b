"""``rgc_slam_tpu_torch.tools.graft_entry`` against the root
``__graft_entry__.py``.

* ENTRY_CONFIG equals ``__graft_entry__.ENTRY_CONFIG`` field by field, and
  ``_example_inputs`` equals JAX's array for array.
* ``fn(*args)`` from the port's ``entry(device="cpu")`` against
  ``jax.jit(fn)(*args)`` from JAX's ``entry()``: ``t_map`` and ``q_map``
  within tests/test_torch_slam.py's one-step gate, max(1e-4, 2 x the JAX
  package's own deviation under 1e-7 relative perturbations of the scan),
  the masks and the keyframe flag equal.
* ``dryrun_multichip(4, n_steps=3, device="cpu")`` passes on 4 gloo ranks
  (dp=2 x sp=2); a dp row whose scans drive elsewhere makes it raise.
* ``main --device cpu`` prints ``entry OK`` and ``dryrun_multichip OK``;
  without CUDA the default device raises.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from rgc_slam_tpu.io.convert import cloud_from_scan_dict as j_cloud
from rgc_slam_tpu_torch.tools import graft_entry
from rgc_slam_tpu_torch.types import tree_items

import torch_eval_roots
import torch_sp_ranks

torch.set_num_threads(1)
PERTURB_SEEDS = (1, 2)


@pytest.fixture(scope="module")
def jentry():
    return torch_eval_roots.load("__graft_entry__")


def _jax_fields(tree) -> dict:
    return {f.name: np.asarray(getattr(tree, f.name)) for f in dataclasses.fields(tree)}


def test_entry_config_matches(jentry):
    assert dataclasses.asdict(graft_entry.ENTRY_CONFIG) == dataclasses.asdict(jentry.ENTRY_CONFIG)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape(n):
    """__graft_entry__.py:97-100's split."""
    assert graft_entry.mesh_shape(n) == ((n // 2, 2) if n >= 2 and n % 2 == 0 else (n, 1))


def test_example_inputs_match(jentry):
    cfg = graft_entry.ENTRY_CONFIG
    t_cloud, t_imu, t_stamp = graft_entry._example_inputs(cfg, device="cpu")
    j_c, j_i, j_stamp = jentry._example_inputs(jentry.ENTRY_CONFIG)
    for port, ref in ((t_cloud, j_c), (t_imu, j_i)):
        jf = _jax_fields(ref)
        tf = {n: v.numpy() for n, v in tree_items(port)}
        assert set(tf) == set(jf)
        for name, value in jf.items():
            assert tf[name].dtype == value.dtype, name
            np.testing.assert_array_equal(tf[name], value, err_msg=name)
    assert t_stamp.dtype == torch.float32 and float(t_stamp) == float(j_stamp)


def test_entry_step_matches_jax(jentry):
    fn, args = graft_entry.entry(device="cpu")
    _, out = fn(*args)
    jfn, jargs = jentry.entry()
    step = jax.jit(jfn)
    _, jout = step(*jargs)
    # the JAX package's own deviation under 1e-7 relative perturbations
    seq = jentry.synthetic.generate_sequence(
        n_scans=3, n_azimuth=120, seed=0, extent=15.0, radius=6.0, noise=0.005,
        closes_loop=False, speed=1.5)
    env_t = env_q = 0.0
    for seed in PERTURB_SEEDS:
        scan = dict(seq["scans"][0])
        g = np.random.default_rng(seed)
        scan["xyz"] = (scan["xyz"] * (1 + 1e-7 * g.standard_normal(scan["xyz"].shape))
                       ).astype(np.float32)
        _, p = step(jargs[0], j_cloud(scan, jentry.ENTRY_CONFIG), *jargs[2:])
        env_t = max(env_t, float(np.abs(np.asarray(p.t_map) - np.asarray(jout.t_map)).max()))
        env_q = max(env_q, float(np.abs(np.asarray(p.q_map) - np.asarray(jout.q_map)).max()))
    dt = np.abs(out.t_map.numpy() - np.asarray(jout.t_map)).max()
    dq = np.abs(out.q_map.numpy() - np.asarray(jout.q_map)).max()
    assert dt <= max(1e-4, 2 * env_t), (dt, env_t)
    assert dq <= max(1e-4, 2 * env_q), (dq, env_q)
    np.testing.assert_array_equal(out.full_mask.numpy(), np.asarray(jout.full_mask))
    assert bool(out.kf_added) == bool(jout.kf_added)
    assert np.isfinite(out.t_map.numpy()).all() and np.isfinite(out.q_map.numpy()).all()


def test_dryrun_multichip_on_cpu_ranks():
    rec = graft_entry.dryrun_multichip(4, n_steps=3, device="cpu")
    assert (rec["n_dp"], rec["n_sp"]) == (2, 2) and rec["steps"] == 2
    assert rec["traj_sh"].shape == rec["traj_ref"].shape == (2, 2, 3)
    assert rec["dev_m"] < graft_entry.GATE_M and np.isfinite(rec["mean_fit"])
    for d in range(2):                                  # rank = dp * 2 + sp
        np.testing.assert_array_equal(rec["ranks"][2 * d]["t_map"], rec["ranks"][2 * d + 1]["t_map"])
    assert [r["launches"] for r in rec["ranks"]] == [0] * 4     # no kernel off the card


def test_diverging_rank_fails_the_dry_run():
    with pytest.raises(AssertionError, match="diverged from single-device vmap"):
        graft_entry.dryrun_multichip(4, n_steps=3, device="cpu",
                                     rank_fn=torch_sp_ranks.diverging_dryrun_rank)


def test_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(graft_entry, "dryrun_multichip",
                        functools.partial(graft_entry.dryrun_multichip, n_steps=3))
    assert graft_entry.main(["2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "entry OK" and out[-1] == "dryrun_multichip OK"
    assert "dp=1 x sp=2" in out[1]


def test_raises_without_cuda():
    assert not torch.cuda.is_available()
    for call in (graft_entry.entry, lambda: graft_entry.dryrun_multichip(2),
                 lambda: graft_entry.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
