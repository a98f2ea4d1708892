"""K1's share of its roofline over the traced frames: the bytes of each
frame's keys and rects (``counts.composite.k1_bound_s``) over the device
time of the ``expand_keys_kernel`` launches of the trace."""

from port_bench.counts.composite import k1_bound_s

LAYER = "kernels"
MOVES = "frame_ms"


def read(r):
    frames = r.captures.get("k1") or []
    if r.trace is None or not frames:
        return None
    times = r.trace.durations(lambda n: "expand_keys_kernel" in n)
    if len(times) != len(frames) or not sum(times):
        return None
    return 100.0 * sum(k1_bound_s(*f) for f in frames) / sum(times)
