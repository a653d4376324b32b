"""The port's SlamConfig copy equals the JAX package's field for field."""
import dataclasses
import importlib

import pytest
import torch

from rgc_slam_tpu import config as jcfg
from rgc_slam_tpu_torch import config as tcfg

torch.set_num_threads(1)


def _fields(cls):
    return [(f.name, str(f.type), f.default) for f in dataclasses.fields(cls)]


def test_fields_and_defaults_equal():
    assert _fields(tcfg.SlamConfig) == _fields(jcfg.SlamConfig)


@pytest.mark.parametrize("name", ["SlamConfig()", "TEST_CONFIG", "FLEET_CONFIG", "BENCH_CONFIG"])
def test_instances_equal(name):
    if name in ("FLEET_CONFIG", "BENCH_CONFIG"):    # bench.py's deployments
        j, t = getattr(importlib.import_module("bench"), name), getattr(tcfg, name)
    else:
        j = jcfg.SlamConfig() if name == "SlamConfig()" else jcfg.TEST_CONFIG
        t = tcfg.SlamConfig() if name == "SlamConfig()" else tcfg.TEST_CONFIG
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.expected_ground_ranges == j.expected_ground_ranges


@pytest.mark.parametrize("kw", [
    dict(sp_shards=3),
    dict(sp_shards=3, sp_features=True),
    dict(n_scans=64),
])
def test_validation_matches(kw):
    """__post_init__ and expected_ground_ranges raise on the same inputs."""
    def outcome(mod):
        try:
            return repr(mod.SlamConfig(**kw).expected_ground_ranges)
        except ValueError as e:
            return f"ValueError: {e}"

    assert outcome(tcfg) == outcome(jcfg)
