"""A cell cut to a size the CPU runs in seconds, for the tests: the port's
test capacities, 240 columns a ring, short logs."""
from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**31 + 7
CAPACITIES = dict(max_points=4096, max_points_per_ring=256, max_source_points=1024,
                  max_voxels=2048, max_keyframes=64, max_kf_corner=128, max_kf_surf=512,
                  max_map_points=4096, max_loops=8, max_loop_submap_points=2048,
                  surrounding_keyframes=12, loop_submap_halfwidth=25, vgicp_max_iterations=15,
                  max_sharp_total=512, max_flat_total=1024, max_inten_total=512)


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def spec(s: dict, **changes) -> dict:
    s = dict(s)
    s["slam_config"] = {**s["slam_config"], **CAPACITIES}
    s["sensor"] = {**s["sensor"], "azimuth": 240}
    s.update(changes)
    return s


def traffic(t: dict, **changes) -> dict:
    return {**t, "log_scans": 16, **changes}
