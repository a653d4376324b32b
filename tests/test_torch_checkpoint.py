"""utils/checkpoint and SlamSystem.save / load of the port.

* a round trip is bit-exact, with and without the loop store, and restores
  the scan counter; the manifest names every tensor with its shape and dtype
  and holds the config;
* ``--localize`` restores the saved map from either layout;
* ``restore`` raises on the first tensor whose shape, dtype or name differs
  from the template (the JAX ``restore`` checks only the leaf count);
* ``SlamSystem(chunk > 1)`` raises the JAX package's two ``ValueError``s,
  with the same messages.
"""
import dataclasses
import json
import os

import pytest
import torch

from rgc_slam_tpu.config import TEST_CONFIG as JCFG
from rgc_slam_tpu.models import slam as jslam
from rgc_slam_tpu_torch import run as t_run
from rgc_slam_tpu_torch.config import TEST_CONFIG as TCFG
from rgc_slam_tpu_torch.models import slam as tslam
from rgc_slam_tpu_torch.types import tree_items, tree_map
from rgc_slam_tpu_torch.utils import checkpoint

torch.set_num_threads(1)


def _randomized(tree, seed: int):
    """``tree`` with every tensor refilled at random (same shape and dtype)."""
    g = torch.Generator().manual_seed(seed)

    def fill(t):
        if t.dtype == torch.bool:
            return torch.rand(t.shape, generator=g) > 0.5
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=g, dtype=t.dtype)
        return torch.randint(-1000, 1000, t.shape, generator=g, dtype=t.dtype)

    return tree_map(fill, tree)


@pytest.mark.parametrize("enable_loop", [False, True])
def test_round_trip_bit_exact(tmp_path, enable_loop):
    cfg = dataclasses.replace(TCFG, loop_cadence=5)
    system = tslam.SlamSystem(cfg, enable_loop=enable_loop, device="cpu")
    system.state = _randomized(system.state, 1)
    if enable_loop:
        system.loop_state = _randomized(system.loop_state, 2)
    system._frame = 37
    system.save(str(tmp_path / "ck"))

    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest["step"] == 37 and manifest["loop_state"] == enable_loop
    assert manifest["config"] == dataclasses.asdict(cfg)
    want = [(f"[0].{k}", list(v.shape), str(v.dtype)) for k, v in tree_items(system.state)]
    if enable_loop:
        want += [(f"[1].{k}", list(v.shape), str(v.dtype)) for k, v in tree_items(system.loop_state)]
    assert [(t["name"], t["shape"], t["dtype"]) for t in manifest["tensors"]] == want

    back = tslam.SlamSystem(cfg, enable_loop=enable_loop, device="cpu")
    back.load(str(tmp_path / "ck"))
    assert back._frame == 37
    pairs = [(system.state, back.state)]
    if enable_loop:
        pairs.append((system.loop_state, back.loop_state))
    n = 0
    for a, b in pairs:
        for (ka, va), (kb, vb) in zip(tree_items(a), tree_items(b)):
            assert ka == kb and va.dtype == vb.dtype and torch.equal(va, vb), ka
            n += 1
    assert n == len(manifest["tensors"])


@pytest.mark.parametrize("enable_loop", [False, True])
def test_localize_restores_the_saved_map(tmp_path, enable_loop):
    """``--localize`` reads the checkpoint's layout from its manifest and
    restores the mapping state bit for bit, with or without the loop store."""
    system = tslam.SlamSystem(TCFG, enable_loop=enable_loop, device="cpu")
    system.state = _randomized(system.state, 3)
    system.save(str(tmp_path / "ck"))
    mapping = t_run._restore_prior_map(str(tmp_path / "ck"), TCFG, "cpu")
    pairs = list(zip(tree_items(system.state.mapping), tree_items(mapping)))
    assert pairs
    for (ka, va), (kb, vb) in pairs:
        assert ka == kb and va.dtype == vb.dtype and torch.equal(va, vb), ka


def _edit_file(path, fn):
    f = os.path.join(path, checkpoint.STATE_FILE)
    tensors = torch.load(f, weights_only=True)
    fn(tensors)
    torch.save(tensors, f)


@pytest.mark.parametrize("change", ["shape", "dtype", "name", "extra"])
def test_restore_raises_on_a_difference(tmp_path, change):
    system = tslam.SlamSystem(TCFG, enable_loop=False, device="cpu")
    path = str(tmp_path / "ck")
    system.save(path)
    like = (tslam.SlamState.init(TCFG, "cpu"),)
    assert checkpoint.restore(path, like)[1] == 0              # unchanged: restores
    if change == "shape":
        like = (tslam.SlamState.init(dataclasses.replace(TCFG, max_keyframes=32), "cpu"),)
        match = r"\[0\]\.mapping\.kf_.*expected"
    elif change == "dtype":
        _edit_file(path, lambda t: t.update({"[0].odo.t_w": t["[0].odo.t_w"].double()}))
        match = r"\[0\]\.odo\.t_w is torch\.float64\[3\], expected torch\.float32\[3\]"
    elif change == "name":
        _edit_file(path, lambda t: t.update({"[0].odo.t_w_renamed": t.pop("[0].odo.t_w")}))
        match = r"no tensor \[0\]\.odo\.t_w$"
    else:
        _edit_file(path, lambda t: t.update({"[0].odo.spare": torch.zeros(3)}))
        match = r"unexpected tensor \[0\]\.odo\.spare"
    with pytest.raises(ValueError, match=match):
        checkpoint.restore(path, like)


@pytest.mark.parametrize("kw", [dict(chunk=17), dict(chunk=7, loop_cadence=16)],
                         ids=["chunk-past-margin", "cadence-gap-past-margin"])
def test_chunk_value_errors_as_jax(kw):
    chunk = kw.pop("chunk")
    with pytest.raises(ValueError) as jerr:
        jslam.SlamSystem(dataclasses.replace(JCFG, **kw), enable_loop=True, chunk=chunk)
    with pytest.raises(ValueError) as terr:
        tslam.SlamSystem(dataclasses.replace(TCFG, **kw), enable_loop=True, chunk=chunk,
                         device="cpu")
    assert str(terr.value) == str(jerr.value)
    # without loops only the chunk bound applies
    ok = chunk <= 16
    try:
        tslam.SlamSystem(dataclasses.replace(TCFG, **kw), enable_loop=False, chunk=chunk,
                         device="cpu")
        assert ok
    except ValueError:
        assert not ok
