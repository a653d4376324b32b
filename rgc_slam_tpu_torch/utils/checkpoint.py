"""Checkpoint / resume for the whole SLAM session: the port of
``rgc_slam_tpu/utils/checkpoint.py``.

The engine state is an explicit tree of tensors, so checkpointing is exact
and total: ``save`` writes every tensor of the tree, by name and moved to
the CPU, to ``<path>/state.pt`` with ``torch.save``, and a manifest
``<path>/manifest.json`` with the step, the ``SlamConfig`` fields, whether
the loop store is present, and each tensor's name, shape and dtype.
``restore`` loads the tensors with ``torch.load(weights_only=True)`` and
checks every name, shape and dtype against the template ``like``, raising
on the first difference (the JAX ``restore`` checks only the leaf count);
it is also the basis of localization in a prior map
(``cfg.map_update=False``), which restores a mapped session's keyframe
store and keeps it frozen.

A checkpoint of ``SlamSystem`` is the tuple ``(state,)`` or ``(state,
loop_state)``; tensor names are the tree paths, e.g. ``[0].odo.q_w``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

STATE_FILE = "state.pt"
MANIFEST_FILE = "manifest.json"


def _named_leaves(tree) -> Tuple[list, Any]:
    """([(name, tensor)] in flatten order, treespec)."""
    leaves, spec = pytree.tree_flatten_with_path(tree)
    return [(pytree.keystr(path), leaf) for path, leaf in leaves], spec


def save(path: str, state: Any, step: int = 0, cfg=None) -> None:
    """Save a state tree to the directory ``path``; ``cfg`` (a
    ``SlamConfig``) goes into the manifest."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    named, _ = _named_leaves(state)
    tensors = {name: leaf.detach().cpu().contiguous() for name, leaf in named}
    manifest = {
        "step": int(step),
        "config": dataclasses.asdict(cfg) if cfg is not None else None,
        "loop_state": isinstance(state, tuple) and len(state) == 2,
        "tensors": [{"name": name, "shape": list(t.shape), "dtype": str(t.dtype)}
                    for name, t in tensors.items()],
    }
    torch.save(tensors, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=1)


def read_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(os.path.abspath(path), MANIFEST_FILE)) as f:
        return json.load(f)


def restore(path: str, like: Any, device: Optional[torch.device] = None) -> Tuple[Any, int]:
    """Restore a tree shaped like ``like`` onto ``device`` (default: each
    leaf's device in ``like``); returns ``(tree, step)``.  Raises
    ``ValueError`` on the first tensor whose name, shape or dtype differs
    from ``like``'s, or on a name ``like`` does not have."""
    path = os.path.abspath(path)
    tensors = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    named, spec = _named_leaves(like)
    leaves = []
    for name, ref in named:
        if name not in tensors:
            raise ValueError(f"checkpoint {path}: no tensor {name}")
        t = tensors[name]
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(f"checkpoint {path}: {name} is {t.dtype}{list(t.shape)}, "
                             f"expected {ref.dtype}{list(ref.shape)}")
        leaves.append(t.to(device if device is not None else ref.device))
    extra = sorted(set(tensors) - {name for name, _ in named})
    if extra:
        raise ValueError(f"checkpoint {path}: unexpected tensor {extra[0]}")
    return pytree.tree_unflatten(leaves, spec), int(read_manifest(path)["step"])
