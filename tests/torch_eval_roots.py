"""The JAX package's evaluation programs at the repo root (``eval.py``,
``eval_pgo.py``, ``eval_longrun.py``, ...), loaded from their files for the
tests of ``rgc_slam_tpu_torch.tools``: their ``main()`` is never called.
"""
import ast
import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name: str):
    """The root script ``<name>.py`` as the module ``jax_root_<name>``."""
    key = f"jax_root_{name}"
    if key not in sys.modules:
        if REPO not in sys.path:
            sys.path.insert(0, REPO)        # eval.py imports bench at run time
        spec = importlib.util.spec_from_file_location(key, os.path.join(REPO, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def assigned(name: str, target: str, namespace: dict):
    """The value the root script ``<name>.py`` assigns to ``target`` at top
    level, evaluated in ``namespace`` without running the script (for
    ``eval_sp.py``, whose import reconfigures JAX's devices)."""
    with open(os.path.join(REPO, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            names = [e.id for e in t.elts] if isinstance(t, ast.Tuple) else [getattr(t, "id", None)]
            if target in names:
                value = eval(compile(ast.Expression(node.value), f"{name}.py", "eval"), namespace)
                return value[names.index(target)] if isinstance(t, ast.Tuple) else value
    raise KeyError(f"{name}.py assigns no {target}")
