"""One stream through ``SlamSystem.process``, as the port's CLI drives it.

Each call converts one sweep's host arrays (``io.convert.cloud_from_scan_dict``
and ``imu_from_interval``) and hands them to ``SlamSystem.process``, which
replays the compiled step, reads the poses to the host and, every
``loop_cadence`` scans, runs the eager loop step.  A sensor without a ring
channel (``sensor.ring_channel`` false) gives each sweep in KITTI's velodyne
format, which the port reads through ``io.kitti.scan_to_cloud``; traffic
without an ``imu`` entry gives empty IMU windows, as ``io.kitti`` does.  The
benchmark times the instance's bound methods from outside (``_step``,
``_record``, ``loop_step``) to label its host spans; the program is not
edited.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from rgc_slam_tpu_torch.config import SlamConfig
from rgc_slam_tpu_torch.io.convert import cloud_from_scan_dict, imu_from_interval
from rgc_slam_tpu_torch.io.kitti import scan_to_cloud
from rgc_slam_tpu_torch.models.slam import SlamSystem
from rgc_slam_tpu_torch.types import ImuBatch

from slambench.drivers import LogExhausted, wrap_method
from slambench.reference import compare
from slambench.traffic import raycast

SAMPLES = 8           # window calls the reference works out again
TRACED_CALLS = 3      # calls in the traced sub-window, the last with a loop step
MAPPING_FIELDS = ("q_md", "t_md", "q_w_last", "t_w_last", "q_w_last2", "t_w_last2",
                  "last_corner", "last_corner_conf", "last_corner_mask", "last_surf",
                  "last_surf_conf", "last_surf_mask", "gflag", "q_w_delta", "imu_ypr_last",
                  "count", "kf_q", "kf_t", "kf_corner", "kf_corner_mask", "kf_surf",
                  "kf_surf_mask", "kf_count")


def view(state) -> dict:
    """The program's state as the reference reads it: named tensors."""
    m, o = state.mapping, state.odo

    def plane(g):
        return {k: getattr(g, k) for k in ("normal", "v1", "v2", "distance", "valid")}

    return {**{k: getattr(m, k) for k in MAPPING_FIELDS},
            "ground_last": plane(m.ground_last), "ground_last2": plane(m.ground_last2),
            "prev_stamp": o.prev_stamp, "bg": o.imu_filter.bg}


class Reservoir:
    """A uniform sample of ``k`` of the calls offered, drawn from the seed
    over however many calls the window makes (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = np.random.default_rng(seed)

    def slot(self) -> int:
        """Where the next call offered goes, or -1 for nowhere."""
        self.seen += 1
        if self.seen <= self.k:
            return self.seen - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else -1

    def put(self, slot: int, item):
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item


class Driver:
    def __init__(self, spec: dict, traffic: dict, seed: int, device, spans, timings: dict):
        self.spec, self.spans, self.dev = spec, spans, torch.device(device)
        self.ref_cfg = compare.settings(spec["slam_config"])
        self.cfg = SlamConfig(**spec["slam_config"])
        if self.cfg.use_imu and "imu" not in traffic:
            raise ValueError("the configuration uses the IMU and the traffic draws none")
        self.ring_channel = spec["sensor"].get("ring_channel", True)
        t0 = time.perf_counter()
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        n_scans = traffic["log_scans"]
        log = raycast.make_log(traffic, spec["sensor"], raycast.world_seeds(seed, 1)[0], n_scans,
                               gen, self.dev)
        host = {k: v.cpu().numpy() for k, v in log["scans"].items()}
        if self.ring_channel:
            self.scans = [{k: host[k][i] for k in host} for i in range(n_scans)]
        else:
            self.scans = [raycast.velodyne_sweep(host, i) for i in range(n_scans)]
        self.imu, self.stamps = log["imu"], log["stamps"]
        self.no_imu = ImuBatch.zeros(self.cfg.max_imu, self.dev) if self.imu is None else None
        self.truth = [t for _, t in log["poses"]]
        timings["inputs_s"] = time.perf_counter() - t0

        self.system = SlamSystem(self.cfg, enable_loop=spec["enable_loop"], device=self.dev)
        self.compiled = wrap_method(self.system, "_step", spans, "replay")
        wrap_method(self.system, "_record", spans, "pose_read")
        wrap_method(self.system, "loop_step", spans, "loop_step")
        self.cadence = self.cfg.loop_cadence if self.system.enable_loop else 0
        self.next = 0
        self.reservoir, self.sampling = None, False
        self.first = None
        # the first call (eager warm-up, capture, instantiation) is kept: it
        # starts from the program's initial state
        t0 = time.perf_counter()
        self.step_call()
        timings["first_call_s"] = time.perf_counter() - t0
        timings["graphs"] = [{"capture_s": g.capture_s, "instantiate_s": g.instantiate_s}
                             for g in self.compiled.graphs]
        # the warm-up: calls up to and including the first loop step, so
        # every kind of call the window makes (a replay, a loop step) has run
        t0 = time.perf_counter()
        while self.next < (self.cadence or 2):
            self.step_call()
        timings["warm_calls_s"] = time.perf_counter() - t0

    def sample(self, seed: int):
        """Sample the calls from now on: ``SAMPLES`` of those that run no
        loop step, drawn from the seed."""
        self.reservoir, self.sampling = Reservoir(SAMPLES, seed), True

    def stop_sampling(self):
        self.sampling = False

    def knn_searches(self):
        c = self.cfg
        per_iter = [(1, c.max_kf_corner, c.max_map_points // 4, c.map_knn)] * 2 + \
                   [(1, c.max_kf_surf, c.max_map_points, c.map_knn)] * 2
        return per_iter * c.map_opt_iterations

    def traced_offset(self) -> int:
        """Calls to skip after the window so the traced sub-window's last
        call runs a loop step."""
        if not self.cadence:
            return 0
        return (-(self.next + TRACED_CALLS)) % self.cadence

    def step_call(self) -> int:
        """Call ``self.next`` of the log: one sweep in, its pose out."""
        i = self.next
        if i >= len(self.scans):
            raise LogExhausted(f"the traffic log holds {len(self.scans)} scans and call {i} "
                               f"needs one more: lengthen log_scans")
        slam = self.system
        before = slam.state
        with self.spans.span("copy_in"):
            if self.ring_channel:
                cloud = cloud_from_scan_dict(self.scans[i], self.cfg, self.dev)
            else:
                cloud = scan_to_cloud(self.scans[i], self.cfg, self.dev)
            if self.imu is None:
                imu = self.no_imu
            else:
                t_imu, acc, gyr = self.imu[i]
                imu = imu_from_interval(t_imu, acc, gyr, self.cfg.max_imu, self.dev)
        slam.process(cloud, imu, self.stamps[i])
        self.next += 1
        self.last_loop = slam.loop_info is not None
        if i == 0:
            self.first = self._record(i, before)
        elif self.sampling and not self.last_loop:
            slot = self.reservoir.slot()
            if slot >= 0:
                self.reservoir.put(slot, self._record(i, before))
        return 1

    def _record(self, i: int, before) -> dict:
        _, q_map, t_map = self.system.trajectory[-1]
        _, q_odom, t_odom = self.system.odom_trajectory[-1]
        return {"i": i, "before": before, "after": self.system.state,
                "poses": (q_map, t_map, q_odom, t_odom)}

    def ate(self):
        """ATE (m) of the map trajectory so far against the log's truth:
        printed, not a metric (float32 chaos moves it between honest runs)."""
        from slambench.run import ate_m

        est = [t for _, _, t in self.system.trajectory]
        return ate_m(est, self.truth[:len(est)])

    def samples(self):
        """The sampled calls in call order, the first call with them."""
        kept = sorted((self.reservoir.items if self.reservoir else []) + [self.first],
                      key=lambda s: s["i"])
        return kept

    def release(self):
        """Free the program; the samples keep only their own tensors."""
        self.system = None
        self.sampled = self.samples()
        self.reservoir = self.first = None

    def calls(self):
        """Each sampled call as the reference reads it: the sweep's arrays
        as handed over, and its IMU window's stamps and gyro (None without
        IMU)."""
        for s in self.sampled:
            i = s["i"]
            q_map, t_map, q_odom, t_odom = (torch.as_tensor(np.asarray(x, np.float32),
                                                            device=self.dev) for x in s["poses"])
            imu = None if self.imu is None else (self.imu[i][0], self.imu[i][2])
            yield {"i": i, "scan": self.scans[i], "imu": imu,
                   "before": view(s["before"]), "after": view(s["after"]),
                   "q_map": q_map, "t_map": t_map, "q_odom": q_odom, "t_odom": t_odom}
