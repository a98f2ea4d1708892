"""K4's share of its roofline over the traced SDS steps: the least time
of every K4 call at its shape and element size (the prior's float32
inputs, ``counts.attention.k4_bound_s``) over the device time of the
``flash_fwd_kernel`` launches, in launch order."""

from port_bench.counts.attention import k4_bound_s

LAYER = "kernels"
MOVES = "gs_step_ms"


def read(r):
    calls = r.captures.get("k4") or []
    if r.trace is None or not calls:
        return None
    times = r.trace.durations(lambda n: "flash_fwd_kernel" in n)
    if len(times) != len(calls) or not sum(times):
        return None
    return 100.0 * sum(k4_bound_s(*c) for c in calls) / sum(times)
