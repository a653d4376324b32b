"""Carry SLAM state between the JAX package and the port as numpy arrays.

Keys are the JAX field paths joined by dots (``"odo.sub_xyz"``,
``"mapping.kf_surf"``, ``"odo.ground_last.normal"``, ...).  A dict with
those keys is built on the JAX side from ``jax.tree_util.
tree_flatten_with_path``; this module never sees jax.  Every key, shape and
dtype must match the port's ``SlamState.init(cfg)`` (or, for the loop
store, ``LoopState.init(cfg)``: keys ``"loop_i"``, ``"loop_count"``, ...)
exactly; a fleet's state (``parallel/fleet.py``) has the same keys with a
leading robot axis on every array, as the JAX fleet's batched leaves have.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import SlamConfig
from .models.loop import LoopState
from .models.slam import SlamState
from .parallel.fleet import fleet_init, fleet_loop_init
from .types import tree_items, tree_map


def tree_from_numpy(template, arrays: Dict[str, np.ndarray], device):
    """A tree shaped like ``template`` whose leaves come from ``arrays``."""
    expected = dict(tree_items(template))
    missing = sorted(set(expected) - set(arrays))
    extra = sorted(set(arrays) - set(expected))
    if missing or extra:
        raise KeyError(f"state keys differ: missing {missing}, unexpected {extra}")
    paths = iter(k for k, _ in tree_items(template))

    def leaf(t):
        key = next(paths)
        a = np.asarray(arrays[key])
        want = str(t.dtype).replace("torch.", "")
        if tuple(a.shape) != tuple(t.shape) or a.dtype != np.dtype(want):
            raise ValueError(f"{key}: got {a.dtype}{list(a.shape)}, "
                             f"expected {want}{list(t.shape)}")
        return torch.from_numpy(np.array(a)).to(device)

    return tree_map(leaf, template)


def state_from_numpy(arrays: Dict[str, np.ndarray], cfg: SlamConfig, device) -> SlamState:
    return tree_from_numpy(SlamState.init(cfg, "cpu"), arrays, device)


def _robots(arrays: Dict[str, np.ndarray], key: str) -> int:
    """The leading robot axis of a fleet's arrays, read off a 0-dim leaf."""
    return int(np.asarray(arrays[key]).shape[0])


def fleet_state_from_numpy(arrays: Dict[str, np.ndarray], cfg: SlamConfig, device) -> SlamState:
    """A fleet's batched SlamState [B, ...] from the JAX fleet's leaves."""
    return tree_from_numpy(fleet_init(cfg, _robots(arrays, "odo.frame"), "cpu"), arrays, device)


def fleet_loop_state_from_numpy(arrays: Dict[str, np.ndarray], cfg: SlamConfig,
                                device) -> LoopState:
    """A fleet's batched LoopState [B, ...] from the JAX fleet's leaves."""
    return tree_from_numpy(fleet_loop_init(cfg, _robots(arrays, "loop_count"), "cpu"), arrays,
                           device)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The leaves of a state tree (``SlamState``, ``LoopState``) by key."""
    return {k: v.detach().cpu().numpy() for k, v in tree_items(state)}


def loop_state_from_numpy(arrays: Dict[str, np.ndarray], cfg: SlamConfig, device) -> LoopState:
    return tree_from_numpy(LoopState.init(cfg, "cpu"), arrays, device)


loop_state_to_numpy = state_to_numpy
