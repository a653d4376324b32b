"""No module of the benchmark loads JAX, flax or the JAX package, and the
reference loads nothing of the program: each checked in a fresh process in
which those names cannot be imported, by the top-level names (compared
whole) of every module it then holds."""
import json
import os
import subprocess
import sys

from slambench.tests.tiny import ROOT

BLOCK = '''
import importlib, importlib.abc, json, pkgutil, sys
BLOCKED = set(sys.argv[1].split(","))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".", 1)[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import slambench
for pkg in sys.argv[2].split(","):
    mod = importlib.import_module(pkg)
    for info in pkgutil.walk_packages(mod.__path__, pkg + "."):
        if ".tests" not in info.name:
            importlib.import_module(info.name)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
'''


def _loaded(blocked, packages):
    out = subprocess.run([sys.executable, "-c", BLOCK, ",".join(blocked), ",".join(packages)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_benchmark_loads_no_jax():
    forbidden = ["jax", "jaxlib", "flax", "rgc_slam_tpu"]
    tops = _loaded(forbidden, ["slambench"])
    assert not tops & set(forbidden)
    assert "rgc_slam_tpu_torch" in tops          # the drivers run the program


def test_reference_loads_nothing_of_the_program():
    forbidden = ["jax", "jaxlib", "flax", "rgc_slam_tpu", "rgc_slam_tpu_torch"]
    tops = _loaded(forbidden, ["slambench.reference", "slambench.traffic", "slambench.metrics"])
    assert not tops & set(forbidden)
