"""FLOPs of the SDS step's prior, counted by ``torch.utils.flop_counter``
over the reference (``reference/sd2``) on ``meta`` tensors at the cell's
shapes: the UNet2D at the CFG batch of 2, the KL encoder's forward at
``sds_size``^2 (twice a step: the differentiable encode and the masked
one) and its backward to the input image (the weights are frozen, so
only the input's gradient is counted). Matrix products and convolutions
are counted; the elementwise work is not. Attention counts its two
products at full length."""

from __future__ import annotations

import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference.sd2 import prior as ref_prior


def sds_flops(cfg: dict) -> dict:
    """{"prior": FLOP of one CFG evaluation, "encode": one encoder
    forward, "encode_backward": its input gradient, "step": the prior's
    and the encoder's FLOPs of one step}, counted once per checkout
    (``harness.cache``)."""
    from port_bench.harness import cache
    key = [cfg["unet"], cfg["vae"], cfg["sds_size"], cfg["text_tokens"],
           cache.sources_key(os.path.dirname(os.path.dirname(
               ref_prior.__file__)))]
    return cache.memo("sd2-sds-flops", key, lambda: _count(cfg))


def _count(cfg: dict) -> dict:
    from port_bench.drivers.sds_step import configs
    with torch.device("meta"):
        prior = ref_prior.Prior(*configs(cfg), cfg["guidance_scale"])
    prior.requires_grad_(False)
    s = cfg["sds_size"]
    img = torch.zeros((1, s, s, 3), device="meta", requires_grad=True)
    out = {}
    with FlopCounterMode(display=False) as fc:
        z = prior.encode(img)
    out["encode"] = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(z.sum(), img)
    out["encode_backward"] = fc.get_total_flops()
    x9 = torch.zeros((1, s // 8, s // 8, cfg["unet"]["in_channels"]),
                     device="meta")
    t = torch.zeros((1,), device="meta")
    embs = torch.zeros((2, cfg["text_tokens"], cfg["unet"]["context_dim"]),
                       device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        prior.eps_cfg(x9, t, embs)
    out["prior"] = fc.get_total_flops()
    out["step"] = out["prior"] + 2 * out["encode"] + out["encode_backward"]
    return out
