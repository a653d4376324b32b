"""Device ms a scan of the step's ``features`` stage (``ops/features``):
from the graph's first mark to the ``features`` mark, read from the
program's trace of the window's calls without a loop step, untraced."""
from slambench.program_trace import mean_over_calls, stage_ms


def read(rec):
    return mean_over_calls(rec, stage_ms("features"))
