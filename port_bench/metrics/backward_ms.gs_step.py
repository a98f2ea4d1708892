"""Mean device ms of a train step's loss and backward (CUDA events from
the end of ``gs_trainer.render`` to the start of ``apply_adam``: L1 +
SSIM, K3, the gather's and the projection's backward)."""

LAYER = "loss and backward"
MOVES = "gs_step_ms"


def read(r):
    ms = r.spans.get("backward")
    return sum(ms) / len(ms) if ms else None
