"""Mean device ms of a clip's temporal VAE decode (CUDA events around
``SVDEngine.decode_first_stage``) over the window's clips."""

LAYER = "VAE decode"
MOVES = "clip_s"


def read(r):
    ms = r.spans.get("decode")
    return sum(ms) / len(ms) if ms else None
