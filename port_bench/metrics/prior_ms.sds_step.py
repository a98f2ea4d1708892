"""Device ms a step of the prior's CFG evaluation (the program's
``sds.prior`` span, with device events, over the window's steps of a
traced run: the UNet2D at the (unconditional | conditional) batch of 2,
K4 on its long self-attention)."""

from port_bench.counts.sds_spans import per_step

LAYER = "SDS prior"
MOVES = "gs_step_ms"


def read(r):
    return per_step(r, "sds.prior")
