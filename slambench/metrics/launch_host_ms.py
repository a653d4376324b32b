"""Host ms a scan in ``CUDAGraph.replay()`` (the program's span ``launch``
in ``CompiledStep._replay``), over the window's calls without a loop
step."""
from slambench.program_trace import mean_over_calls, span_ms


def read(rec):
    return mean_over_calls(rec, span_ms("launch"))
