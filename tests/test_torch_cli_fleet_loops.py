"""The port's fleet CLI with loops on (``make_fleet_chunk_step``) against
the JAX CLI's: tests/test_torch_cli_fleet.py's check, with loops."""
from test_torch_cli_fleet import log, run_and_check  # noqa: F401  (log is a fixture)


def test_cli_fleet_chunked_loops(log, tmp_path, monkeypatch):  # noqa: F811
    run_and_check(log, tmp_path, monkeypatch, loops=True)
