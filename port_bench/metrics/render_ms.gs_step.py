"""Mean device ms of a train step's forward render (CUDA events from the
step's start to the end of ``gs_trainer.render``: projection, binning,
K1, the sort, the gather, K2) over the window's steps."""

LAYER = "forward render"
MOVES = "gs_step_ms"


def read(r):
    ms = r.spans.get("render")
    return sum(ms) / len(ms) if ms else None
