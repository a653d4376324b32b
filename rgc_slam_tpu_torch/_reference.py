"""Load the JAX package's numpy-only modules without importing jax.

Any ``import rgc_slam_tpu.<module>`` first runs ``rgc_slam_tpu/__init__.py``,
which imports jax; a machine that runs only the port has no jax.  The two
modules the port reuses, ``io/synthetic.py`` (the synthetic sequence
generator) and ``utils/evaluation.py`` (ATE and the TUM writer), import
only numpy, so they are loaded here by file path and that ``__init__``
never runs.  They are reused as they are, not copied.
"""
from __future__ import annotations

import importlib.util
import os
import sys
from types import ModuleType

_JAX_PKG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rgc_slam_tpu"
)
_FILES = {
    "synthetic": os.path.join("io", "synthetic.py"),
    "evaluation": os.path.join("utils", "evaluation.py"),
}


def load(name: str) -> ModuleType:
    """Return the JAX package's numpy-only module ``name`` ("synthetic" or
    "evaluation"), loaded once by file path."""
    mod_name = f"rgc_slam_tpu_torch._reference_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = os.path.join(_JAX_PKG, _FILES[name])
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod
