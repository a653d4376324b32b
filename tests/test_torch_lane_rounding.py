"""``tools/lane_rounding.py``, the search for the first function of the
fleet step that rounds identical lanes apart, on the CPU: it finds a split
planted in a watched function, and it finds none in two identical lanes of
the fleet step at TEST_CONFIG (the lanes stay bit-equal)."""
import dataclasses

import torch

from rgc_slam_tpu_torch.config import TEST_CONFIG
from rgc_slam_tpu_torch.tools import lane_rounding

torch.set_num_threads(1)


def test_watch_finds_a_planted_split():
    watch = lane_rounding.Watch()
    noisy = watch.wrap("noisy", lambda x: x + 1e-6 * torch.rand_like(x))
    same = watch.wrap("same", lambda x: 2 * x)
    x = torch.ones(4, 3)
    torch.func.vmap(lambda r: noisy(same(r)), randomness="different")(x)
    assert watch.found["function"] == "noisy" and 0 < watch.found["max_lane_diff"] < 1e-5


def test_identical_lanes_round_alike():
    cfg = dataclasses.replace(TEST_CONFIG, loop_closure_enable=False, inline_compaction=False)
    out = lane_rounding.run(cfg, lanes=2, scans=2, n_azimuth=240, device="cpu")
    assert out["first_split"] is None, out["first_split"]
    assert [s["t_map_spread_m"] for s in out["steps"]] == [0.0, 0.0]
    from rgc_slam_tpu_torch.ops import features
    assert not hasattr(features.extract_features, "__wrapped__")     # restored
