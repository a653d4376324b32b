"""Device ms a scan of ``CompiledStep._replay``'s copies outside the graph:
the copy-in into the static buffers (between the events before and after
it) plus the clones of the state and outputs (between the events after the
replay and after the clones), from the program's trace of the window's
calls without a loop step."""
from slambench.program_trace import device_ms, mean_over_calls


def read(rec):
    return mean_over_calls(rec, device_ms("copy_in", "clone"))
