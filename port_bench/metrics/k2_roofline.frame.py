"""K2's share of its roofline over the frames whose pair lists the
traced run kept: their least time (``counts.composite``: the walk's
operations or the kernel's bytes) over the device time of the first
``composite_kernel`` launches of the trace."""

from port_bench.counts.composite import roofline

LAYER = "kernels"
MOVES = "frame_ms"


def read(r):
    return roofline(r, "composite_kernel", 1)
