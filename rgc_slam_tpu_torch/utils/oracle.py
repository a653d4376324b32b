"""Golden oracle: the reference's EXACT sequential feature picker in numpy.

`ops/features._greedy_pick` re-expresses scanRegistration.cpp:469-644 as
parallel argmax-and-suppress rounds; this module replays the C++ loop
verbatim (per-ring 6-sector std::sort order, sequential suppression state
carried across sectors and rings, the ±5 break-on-gap neighbor marking, the
20/40/20 per-sector caps) so tests can measure exactly how far the parallel
reformulation deviates (VERDICT r1 item 6).  Host-side, intentionally slow.

Faithfulness notes (deliberate quirks of the C++ kept here):
  * suppression indices ind±l are GLOBAL — they can run across sector and
    ring boundaries (the engine's picker gates on same-ring, a correction);
  * cloudNeighborPicked is shared between the sharp and flat passes and
    persists across sectors/rings; intensity uses its own array;
  * ties in std::sort are broken by value order; we use argsort(kind=stable)
    so equal scores resolve by index.

A copy of ``rgc_slam_tpu/utils/oracle.py``, kept in the port so that it
imports nothing of the JAX package; ``tests/test_torch_parity_copies.py``
holds the two to the same results.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def reference_pick(
    xyz: np.ndarray,           # [N, 3] organized ring-major
    curvature: np.ndarray,     # [N]
    curvature2: np.ndarray,    # [N]
    inten_curv: np.ndarray,    # [N]
    intensity: np.ndarray,     # [N] (incidence-smoothed, = intensity_num)
    ground_mask: np.ndarray,   # [N] bool (groundcloudMarked)
    blocked: np.ndarray,       # [N] bool occlusion pre-marks -> neighborPicked
    ring_start: np.ndarray,    # [n_scans]
    ring_count: np.ndarray,    # [n_scans]
    max_sharp: int = 20,
    max_flat: int = 40,
    max_inten: int = 20,
    sharp_curv: float = 0.1,
    sharp_curv2: float = 0.3,
    flat_curv: float = 0.3,
    flat_curv2: float = 0.4,
    inten_thresh: float = 65.0,
    n_sectors: int = 6,
) -> Dict[str, np.ndarray]:
    """Returns dict(sharp, flat, inten) boolean pick masks over the organized
    cloud — the exact sets the C++ node's sorted sequential loops select."""
    n = len(xyz)
    picked = np.asarray(blocked, bool).copy()     # cloudNeighborPicked
    ipicked = np.zeros(n, bool)                   # intenNeighborPicked
    label = np.zeros(n, np.int8)                  # cloudLabel (2=sharp)
    sharp = np.zeros(n, bool)
    flat = np.zeros(n, bool)
    inten = np.zeros(n, bool)

    def suppress(arr, ind, gap_sq_ok):
        # forward: ind+1..ind+5 while consecutive gap holds (cpp:517-534)
        for l in range(1, 6):
            if ind + l >= n or not gap_sq_ok(ind + l, ind + l - 1):
                break
            arr[ind + l] = True
        for l in range(1, 6):
            if ind - l < 0 or not gap_sq_ok(ind - l, ind - l + 1):
                break
            arr[ind - l] = True

    def xyz_gap_ok(a, b):
        d = xyz[a] - xyz[b]
        return float(d @ d) <= 0.05

    def inten_gap_ok(a, b):
        return abs(float(intensity[a]) - float(intensity[b])) <= 35.0

    for i in range(len(ring_start)):
        cnt = int(ring_count[i])
        if cnt - 11 < 10:                          # scanEnd-scanStart < 10
            continue
        start = int(ring_start[i]) + 5             # scanStartInd (+5 trim)
        end = int(ring_start[i]) + cnt - 6         # scanEndInd (inclusive)
        for j in range(n_sectors):
            sp = start + (end - start) * j // n_sectors
            ep = start + (end - start) * (j + 1) // n_sectors - 1
            if j == n_sectors - 1:
                ep = end - 1                       # cpp's ep never reaches end
            seg = np.arange(sp, ep + 1)
            order_c = seg[np.argsort(curvature[seg], kind="stable")]
            order_i = seg[np.argsort(inten_curv[seg], kind="stable")]

            # ---- sharp: largest curvature first (cpp:487-537) ----
            npick = 0
            for ind in order_c[::-1]:
                if picked[ind] or ground_mask[ind]:
                    continue
                if not (curvature[ind] > sharp_curv and curvature2[ind] > sharp_curv2):
                    continue
                npick += 1
                if npick <= max_sharp:
                    label[ind] = 2
                    sharp[ind] = True
                elif npick <= max_sharp + 1:
                    label[ind] = 1                 # less-sharp only
                else:
                    break
                picked[ind] = True
                suppress(picked, ind, xyz_gap_ok)

            # ---- flat: smallest curvature first (cpp:539-583) ----
            npick = 0
            for ind in order_c:
                if picked[ind]:
                    continue
                if not (curvature[ind] < flat_curv and curvature2[ind] < flat_curv2):
                    continue
                npick += 1
                if npick <= max_flat:
                    label[ind] = -1
                    flat[ind] = True
                else:
                    break
                picked[ind] = True
                suppress(picked, ind, xyz_gap_ok)

            # ---- intensity corners (cpp:594-644) ----
            npick = 0
            for ind in order_i[::-1]:
                if ipicked[ind] or ground_mask[ind]:
                    continue
                if not (inten_curv[ind] > inten_thresh):
                    continue
                if label[ind] in (1, 2):
                    continue
                npick += 1
                if npick <= max_inten:
                    inten[ind] = True
                elif npick <= max_inten + 1:
                    pass                           # less-sharp only
                else:
                    break
                ipicked[ind] = True
                suppress(ipicked, ind, inten_gap_ok)

    return {"sharp": sharp, "flat": flat, "inten": inten}
