"""Device ms a step of the SDS step's one backward (the program's
``sds.backward`` span around ``torch.autograd.grad``, with device
events, over the window's steps of a traced run: the SDS loss through
the KL encoder, the resize, the background loss, K3, the gather and the
projection)."""

from port_bench.counts.sds_spans import per_step

LAYER = "loss and backward"
MOVES = "gs_step_ms"


def read(r):
    return per_step(r, "sds.backward")
