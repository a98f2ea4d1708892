"""The whole train step's share of the chip's peaks: the least time of
a step's counted work (``counts.splat_step.step_bound_s``: parameters,
gradients and Adam moments read and written once, the frame and target
once, K1-K3 as ``counts.composite`` bounds them) over the window's mean
step time (the traced steps run after it)."""

from port_bench.counts.composite import captured_bounds
from port_bench.counts.splat_step import step_bound_s

LAYER = "whole step"
MOVES = "gs_step_ms"


def read(r):
    bounds = captured_bounds(r)
    if (r.trace is None or not r.trace.busy_s or not bounds
            or not r.traced_units):
        return None
    least = sum(step_bound_s(r.captures["splats"], r.captures["pixels"],
                             *b) for b in bounds) / len(bounds)
    seconds = r.unit_s()
    return 100.0 * least / seconds if seconds else None
