"""``rgc_slam_tpu_torch.tools.eval``'s config 5b courses against ``eval.py``'s.

``sequence("5b", quick)``: the four distinct closed courses of
``eval.py:317-323`` (seeds 40-43, 1.4 laps), each's first 3 scans, IMU
windows, stamps and poses bit for bit equal to the JAX package's
``io.synthetic`` with the same arguments, at the port's quick length
(QUICK_5B_SCANS, config 2's; eval.py's full length N_5B is the same call
with another ``n_scans``).
"""
import numpy as np
import torch

from rgc_slam_tpu.io import synthetic as jsyn
from rgc_slam_tpu_torch.tools import eval as teval

from test_torch_eval import assert_same_head

torch.set_num_threads(1)


def test_5b_quick_courses_match_eval_py():
    port = teval.sequence("5b", True)
    assert len(port) == 4 and teval.N_5B == 300
    for s, seq in enumerate(port):
        ref = jsyn.generate_sequence(
            n_scans=teval.QUICK_5B_SCANS, n_azimuth=900, seed=40 + s, extent=26.0,
            radius=10.0, noise=0.01, closes_loop=True, laps=1.4,
        )
        assert_same_head(seq, ref)
        assert np.array_equal(seq["world"].boxes, ref["world"].boxes)
