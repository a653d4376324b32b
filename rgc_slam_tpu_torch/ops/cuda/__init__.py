"""The port's hand-written CUDA: each ``csrc/*.cu`` is a plain C entry point
compiled by ``nvcc`` at first use into ``rgc_slam_tpu_torch/_build/`` and
loaded with ctypes (``knn``: the kNN kernel; ``map_lm``: the mapping LM's
linearisation; ``graph_if``: conditional nodes in a captured CUDA graph).

A kernel wrapper that counts its calls enters its counts here
(``register_counts``), so that ``utils.graph`` collects what a capture
records and adds what a replay runs for every such kernel without naming
one.  A wrapper registers when its module is first imported; a call
recorded into a graph before that raises in the wrapper."""
from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


# kernel name -> (capture_counts, add_replayed) of its wrapper
_COUNTED: dict = {}


def register_counts(name: str, capture_counts, add_replayed):
    """Enter a wrapper's counts: ``capture_counts()`` a context that yields a
    Counter of the calls recorded into a CUDA graph being captured,
    ``add_replayed(counter)`` what one replay of such a graph ran."""
    _COUNTED[name] = (capture_counts, add_replayed)


@contextlib.contextmanager
def capture_counts():
    """Around a CUDA graph's capture: yields {kernel name: Counter of its
    calls recorded into the graph} for every registered wrapper."""
    with contextlib.ExitStack() as stack:
        yield {name: stack.enter_context(cap()) for name, (cap, _) in _COUNTED.items()}


def add_replayed(counts: dict):
    """Add one replay of a graph (``capture_counts``' dict, frozen) to each
    wrapper's count of replayed calls."""
    for name, counter in counts.items():
        _COUNTED[name][1](counter)


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA sources are built on a machine "
                       "with the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_library(source: str, library: str, verbose: bool = False) -> str:
    """Compile ``source`` into the shared library ``library`` unless the
    library is newer than the source; returns its path.  ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's report (registers, shared
    memory, spills)."""
    if (not verbose and os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source)):
        return library
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), source, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, library)
    return library
