"""The port's stages against the port's own copy of the numpy oracles, at
the gates of tests/test_parity_oracles.py (PARITY.md:232-242), one case per
test there: ``rgc_slam_tpu_torch/utils/parity_gates.py`` on the CPU, the
same gates that ``chip_smoke.py`` phase 9b runs on the card.
"""
import pytest
import torch

from rgc_slam_tpu_torch.utils import parity_gates

torch.set_num_threads(1)

# tests/test_parity_oracles.py's test of each gate
JAX_TESTS = {
    "ground_fit": "test_ground_fit_parity",
    "complementary_filter": "test_complementary_filter_parity",
    "vgicp_linearize": "test_vgicp_linearize_parity",
    "lm_schedule": "test_lm_schedule_parity",
    "fourdof_residual": "test_fourdof_residual_parity",
    "pgo_solve": "test_pgo_solve_parity",
    "mapping_solve": "test_mapping_solve_parity",
    "odometry_fusion": "test_odometry_fusion_parity",
    "loop_icp": "test_loop_icp_parity",
    "rel_time": "test_rel_time_matches_reference_machine",
    "deskew": "test_deskew_parity",
}


def test_one_gate_per_jax_test():
    import test_parity_oracles

    jax_tests = sorted(n for n in vars(test_parity_oracles) if n.startswith("test_"))
    assert sorted(JAX_TESTS.values()) == jax_tests
    assert list(JAX_TESTS) == list(parity_gates.GATES)


@pytest.mark.parametrize("gate", list(JAX_TESTS))
def test_port_meets_oracle_gate(gate):
    """The gate raises ``AssertionError`` where a limit is crossed."""
    record = parity_gates.GATES[gate]("cpu")
    if gate == "lm_schedule":       # on the CPU, the JAX test's gate: the float64 oracle's trace
        assert record["oracle_dtype"] == "float64", record
