"""Device ms a step of the SDS step's forward render (the program's
``render`` span inside ``sds.step``, with device events, over the
window's steps of a traced run: projection, binning, K1, the sort, the
gather, K2)."""

from port_bench.counts.sds_spans import per_step

LAYER = "forward render"
MOVES = "gs_step_ms"


def read(r):
    return per_step(r, "render")
