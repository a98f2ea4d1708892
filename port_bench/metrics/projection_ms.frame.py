"""Mean device ms of a frame's projection (CUDA events around
``ops/rasterizer/api.project``: activations, EWA projection, SH colours)
over the window's frames."""

LAYER = "projection"
MOVES = "frame_ms"


def read(r):
    ms = r.spans.get("projection")
    return sum(ms) / len(ms) if ms else None
