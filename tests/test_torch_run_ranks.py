"""``parallel.distributed.run_ranks`` called from a script with no
``if __name__ == "__main__":`` guard, and from a program run with
``python -m``.

Each script case writes such a script: it appends one line to a marker
file at its top level, then calls ``run_ranks(..., world=2,
device="cpu")``.  The ranks must never run the script, so the marker holds
exactly one line whatever the outcome:

* the ranks' function from an importable module (tests/torch_sp_ranks.py):
  the call succeeds with both ranks' results;
* the ranks' function defined in the script itself: the call fails at
  once, before any rank starts, with a message that names the guard.

Under ``multiprocessing``'s spawn each rank re-ran the script first (three
lines, and a rank that failed only after the script's work).  A program
run as ``python -m <module>`` may hand its own function to the ranks: they
import the module by name, so its ``__main__`` block (which writes the
marker) runs once.
"""
import os
import subprocess
import sys
import textwrap
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
TIMEOUT_S = 120

SCRIPT = """\
import sys
sys.path[:0] = [{root!r}, {tests!r}]
with open({marker!r}, "a") as f:
    f.write("top level\\n")

from rgc_slam_tpu_torch.parallel.distributed import run_ranks
import torch_sp_ranks


def local_rank_fn(rank, world, device):
    return rank


fn = {fn}
print("results", run_ranks(fn, 2, "cpu", timeout_s={timeout}))
"""

CASES = {
    "module function": ("torch_sp_ranks.psum_of_ranks", 0),
    "function in the script": ("local_rank_fn", 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_unguarded_script_runs_its_top_level_once(tmp_path, case):
    fn, rc = CASES[case]
    marker = tmp_path / "marker.txt"
    script = tmp_path / "unguarded.py"
    script.write_text(SCRIPT.format(root=ROOT, tests=TESTS, marker=str(marker), fn=fn,
                                    timeout=TIMEOUT_S))
    start = time.monotonic()
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=TIMEOUT_S + 60, cwd=tmp_path)
    elapsed = time.monotonic() - start
    assert marker.read_text().splitlines() == ["top level"], proc.stderr[-2000:]
    assert proc.returncode == rc, proc.stderr[-2000:]
    if rc == 0:
        assert "results [(0, 1.0), (1, 1.0)]" in proc.stdout, proc.stdout
    else:
        err = proc.stderr.splitlines()[-1]
        assert err.startswith("ValueError: run_ranks: local_rank_fn is defined in __main__"), err
        assert 'if __name__ == "__main__":' in err, err
        assert elapsed < TIMEOUT_S / 4, elapsed


MODULE = """\
import sys
sys.path[:0] = [{root!r}]

from rgc_slam_tpu_torch.parallel.distributed import run_ranks


def rank_fn(rank, world, device):
    return rank, __name__


if __name__ == "__main__":
    with open({marker!r}, "a") as f:
        f.write("main block\\n")
    print("results", run_ranks(rank_fn, 2, "cpu", timeout_s={timeout}))
"""


def test_module_run_with_dash_m_hands_over_its_own_function(tmp_path):
    marker = tmp_path / "marker.txt"
    (tmp_path / "ranked_prog.py").write_text(MODULE.format(root=ROOT, marker=str(marker),
                                                           timeout=TIMEOUT_S))
    proc = subprocess.run([sys.executable, "-m", "ranked_prog"], capture_output=True, text=True,
                          timeout=TIMEOUT_S + 60, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "results [(0, 'ranked_prog'), (1, 'ranked_prog')]" in proc.stdout, proc.stdout
    assert marker.read_text().splitlines() == ["main block"]
