"""The whole SDS step's share of the chip's peaks: the least time of a
step's counted work over the window's mean step time (the traced steps
run after it). The least time is the prior's and the encoder's FLOPs
(``counts.sds_flops``: the UNet2D at CFG batch 2, two encoder forwards,
the encoder's input gradient) at the bf16 tensor-core peak, whatever
precision the program computes in, plus the splats' least time
(``counts.splat_step.step_bound_s`` on the captured frames)."""

from port_bench.counts.composite import captured_bounds
from port_bench.counts.peaks import BF16_FLOP_PER_S
from port_bench.counts.sds_flops import sds_flops
from port_bench.counts.splat_step import step_bound_s

LAYER = "whole step"
MOVES = "gs_step_ms"


def read(r):
    bounds = captured_bounds(r)
    if (r.trace is None or not r.trace.busy_s or not bounds
            or not r.traced_units):
        return None
    splats = sum(step_bound_s(r.captures["splats"], r.captures["pixels"],
                              *b) for b in bounds) / len(bounds)
    least = sds_flops(r.config)["step"] / BF16_FLOP_PER_S + splats
    seconds = r.unit_s()
    return 100.0 * least / seconds if seconds else None
