"""Every name in BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract."""
import importlib
import json
import os
import re

import pytest

from slambench.tests.tiny import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = bench()
CELLS = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]


def _json(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len(json.dumps(B)) <= 64 * 1024
    for p in B["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p)) and not p.startswith("/") and ".." not in p


def test_names_units_and_keys():
    names = [c["name"] for c in B["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}


@pytest.mark.parametrize("cfg", B["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    spec = _json(cfg["file"])
    assert spec["name"] == cfg["name"] and spec["reduced"] == cfg["reduced"]
    assert os.path.exists(os.path.join(ROOT, "slambench", "drivers", spec["driver"] + ".py"))
    driver = importlib.import_module("slambench.drivers." + spec["driver"])
    assert hasattr(driver, "Driver") and driver.TRACED_CALLS >= 1
    assert any(w["config"] == cfg["name"] for w in B["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = next(x for x in B["workloads"] if x["name"] == cell)
    traffic = _json(os.path.join("slambench", "traffic", w["traffic"] + ".json"))
    assert traffic["name"] == w["traffic"]
    limits = _json(os.path.join("slambench", "limits", cell + ".json"))
    from slambench.reference.compare import NUMBERS

    assert set(limits) == set(NUMBERS)
    e2e = [m["name"] for m in B["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m.get("workloads", [cell]) for m in B["per_layer"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_resolves(metric):
    mod = importlib.import_module("slambench.metrics." + metric["name"])
    assert callable(mod.read)
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
