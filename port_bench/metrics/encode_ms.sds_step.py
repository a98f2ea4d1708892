"""Device ms a step of the SDS step's two encodes (the program's
``sds.encode`` spans, with device events, over the window's steps of a
traced run: the KL encoder's forward at 512^2, the differentiable one
and the masked one)."""

from port_bench.counts.sds_spans import per_step

LAYER = "SDS encode"
MOVES = "gs_step_ms"


def read(r):
    return per_step(r, "sds.encode")
