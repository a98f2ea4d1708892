"""The whole clip's share of the bf16 tensor-core peak: the clip's
matrix-product FLOPs (``counts.svd_flops``, the frozen reference counted
on meta tensors at the cell's shapes) over the window's mean
clip time (the traced clip runs after the window), x 989 TFLOP/s."""

from port_bench.counts.peaks import BF16_FLOP_PER_S
from port_bench.counts.svd_flops import clip_flops

LAYER = "whole step"
MOVES = "clip_s"


def read(r):
    if r.trace is None or not r.trace.busy_s or not r.traced_units:
        return None
    flop = clip_flops(r.config, r.captures["steps"])["clip"]
    seconds = r.unit_s()
    if not seconds:
        return None
    return 100.0 * flop / (seconds * BF16_FLOP_PER_S)
