"""FLOPs of one inpainted clip, counted by ``torch.utils.flop_counter``
over the frozen reference on ``meta`` tensors at the cell's shapes: the
conditioning of c and uc (the CLIP tower and the VAE encoder, twice),
``steps`` evaluations of ControlNet + UNet on the uc|c batch, and the
temporal VAE decode. Matrix products and convolutions are counted; the
elementwise work is not. Attention counts its two products at full
length."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference.svd.model import ReferenceSVD


def _meta_inputs(cfg, h, w):
    t = cfg["num_frames"]
    one = torch.ones((1,), device="meta")
    batch = {"control_hint": torch.zeros((t, h, w, 7), device="meta"),
             "cond_frames_without_noise": torch.zeros((1, h, w, 3),
                                                      device="meta"),
             "cond_frames": torch.zeros((1, h, w, 3), device="meta"),
             "fps_id": one, "motion_bucket_id": one, "cond_aug": one}
    return batch, torch.zeros((t, h // 8, w // 8, 4), device="meta")


def clip_flops(cfg: dict, steps: int) -> dict:
    """{"cond": FLOP, "evaluation": FLOP of one CFG evaluation, "decode":
    FLOP, "clip": the whole clip}, counted once per checkout
    (``harness.cache``)."""
    import os

    from port_bench.harness import cache
    from port_bench.reference.svd import model
    key = [cfg, steps, cache.sources_key(os.path.dirname(model.__file__))]
    return cache.memo("svd-clip-flops", key,
                      lambda: _count_clip(cfg, steps))


def _count_clip(cfg: dict, steps: int) -> dict:
    h, w = cfg["resolution"]
    with torch.device("meta"):
        ref = ReferenceSVD(cfg, dtype=torch.bfloat16)
    batch, x = _meta_inputs(cfg, h, w)
    out = {}
    with FlopCounterMode(display=False) as fc:
        c = ref.cond(batch)
        uc = ref.cond(batch, unconditional=True)
    out["cond"] = fc.get_total_flops()
    s = torch.ones((2 * x.shape[0],), device="meta")
    gx, gs, gc = ref.guider.prepare(x, s[:x.shape[0]], c, uc)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.apply_model(gx, gs, gc)
    out["evaluation"] = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        ref.decode(x)
    out["decode"] = fc.get_total_flops()
    out["clip"] = out["cond"] + steps * out["evaluation"] + out["decode"]
    return out

