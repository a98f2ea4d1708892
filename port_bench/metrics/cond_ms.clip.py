"""Mean device ms of a clip's conditioning of c and uc (CUDA events
around ``SVDEngine.prepare_cond``: the CLIP tower, the VAE encoder, the
fourier vector) over the window's clips."""

LAYER = "engine conditioning"
MOVES = "clip_s"


def read(r):
    ms = r.spans.get("cond")
    return sum(ms) / len(ms) if ms else None
