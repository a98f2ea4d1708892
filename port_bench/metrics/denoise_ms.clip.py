"""Device ms per denoiser evaluation (ControlNet + UNet at CFG batch
2 x frames, with the sampler's update): CUDA events around
``SVDEngine.sample`` over the window, divided by its evaluations."""

LAYER = "denoiser"
MOVES = "clip_s"


def read(r):
    ms = r.spans.get("denoise")
    steps = r.captures.get("steps")
    return sum(ms) / (len(ms) * steps) if ms and steps else None
