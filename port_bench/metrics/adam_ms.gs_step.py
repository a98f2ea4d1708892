"""Mean device ms of a train step's grouped Adam (CUDA events around
``gs_trainer.apply_adam``)."""

LAYER = "optimiser"
MOVES = "gs_step_ms"


def read(r):
    ms = r.spans.get("adam")
    return sum(ms) / len(ms) if ms else None
