"""The share of the VGICP LM's static work that is used: 100 x the inner
iterations its lanes ran (``SlamOutput.lm_iters[1]``, counted on the device)
/ the inner iterations its static counts run (``vgicp_max_iterations`` x
``lm_max_inner`` a scan), mean over the window's calls without a loop
step."""
from slambench.program_trace import mean_over_calls


def used_pct(r):
    c = r.counters
    if not c.get("lm_inner_static"):
        return None
    return 100.0 * c["lm_inner"] / c["lm_inner_static"]


def read(rec):
    return mean_over_calls(rec, used_pct)
