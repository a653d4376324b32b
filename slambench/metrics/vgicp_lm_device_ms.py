"""Device ms a scan of the step's ``vgicp_lm`` stage (``ops/registration.
lm_register`` at its static iteration counts, fitness included), read from
the program's trace of the window's calls without a loop step, untraced."""
from slambench.program_trace import mean_over_calls, stage_ms


def read(rec):
    return mean_over_calls(rec, stage_ms("vgicp_lm"))
