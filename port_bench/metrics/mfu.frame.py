"""The whole frame's share of the chip's peaks: the least time of a
frame's counted work (``counts.splat_step.frame_bound_s``: the
parameters read and the frame written once, K1 and K2 as
``counts.composite`` bounds them) over the window's mean
frame time (the traced frames run after it)."""

from port_bench.counts.composite import captured_bounds
from port_bench.counts.splat_step import frame_bound_s

LAYER = "whole step"
MOVES = "frame_ms"


def read(r):
    bounds = captured_bounds(r)
    if (r.trace is None or not r.trace.busy_s or not bounds
            or not r.traced_units):
        return None
    least = sum(frame_bound_s(r.captures["splats"], r.captures["pixels"],
                              b[0], b[1]) for b in bounds) / len(bounds)
    seconds = r.unit_s()
    return 100.0 * least / seconds if seconds else None
