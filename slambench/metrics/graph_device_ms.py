"""Device ms a scan of the whole replayed graph, its first mark to its last
(the state's copy included): the untraced counterpart of
``replay_device_ms``, read from the program's trace of the window's calls
without a loop step."""
from slambench.program_trace import device_ms, mean_over_calls


def read(rec):
    return mean_over_calls(rec, device_ms("graph"))
