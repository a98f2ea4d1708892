"""Shared diffusion building blocks (PyTorch, NCHW inside modules).

Counterpart of ``multiview_inpaint_tpu/diffusion/layers.py``: the
sinusoidal timestep embedding in ``[cos | sin]`` order, GroupNorm(32) in
f32 whatever the compute type, the learned AlphaBlender that mixes the
spatial and temporal branches, nearest x2 Upsample and the stride-2
Downsample with symmetric padding 1. Parameter names follow the reference
torch key space (``sgm/modules/diffusionmodules``), so that
``load_state_dict`` reads its checkpoints.

Every module takes the factory keywords ``device`` and ``dtype`` and
creates its parameters there, so the full model is built on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """[N] timesteps -> [N, dim] f32 sinusoidal embedding, ``[cos | sin]``
    (the sgm/openai order, which weight import depends on)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(min(32, C)) computed in f32 whatever the input type; the
    output keeps the input type."""

    def __init__(self, channels: int, eps: float = 1e-5, **factory):
        super().__init__(min(32, channels), channels, eps=eps, **factory)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def zero_(module: nn.Module) -> nn.Module:
    """Zero a module's parameters in place (the reference's
    ``zero_module``) and return it."""
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    return module


class AlphaBlender(nn.Module):
    """Learned spatial/temporal mix: ``a * spatial + (1 - a) * temporal``.

    ``merge_strategy``: "fixed" (constant ``alpha``), "learned"
    (``sigmoid(mix_factor)``) or "learned_with_images" (frames flagged 1
    in ``image_only_indicator`` [B, T] use the spatial branch alone). The
    indicator is flattened over the leading ``(b t)`` dimension of x.
    """

    def __init__(self, alpha: float = 0.5,
                 merge_strategy: str = "learned_with_images", **factory):
        super().__init__()
        self.merge_strategy = merge_strategy
        self.alpha = alpha
        if merge_strategy != "fixed":
            self.mix_factor = nn.Parameter(torch.zeros(
                1, device=factory.get("device"),
                dtype=factory.get("dtype") or torch.float32))

    def forward(self, x_spatial, x_temporal, image_only_indicator=None):
        if self.merge_strategy == "fixed":
            a = torch.tensor(self.alpha, dtype=torch.float32,
                             device=x_spatial.device)
        else:
            a = torch.sigmoid(self.mix_factor)[0]
            if self.merge_strategy == "learned_with_images":
                if image_only_indicator is None:
                    raise ValueError("learned_with_images needs the "
                                     "image_only_indicator")
                flat = image_only_indicator.reshape(-1) > 0
                a = torch.where(flat, torch.ones_like(a), a)
                a = a.reshape((-1,) + (1,) * (x_spatial.ndim - 1))
        a = a.to(x_spatial.dtype)
        return a * x_spatial + (1.0 - a) * x_temporal


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv (``conv``)."""

    def __init__(self, channels: int, out_channels: int | None = None,
                 **factory):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels or channels, 3,
                              padding=1, **factory)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Downsample(nn.Module):
    """Stride-2 3x3 conv with symmetric padding 1 (``op``; the torch
    reference's ``conv(stride=2, padding=1)``; flax's SAME would pad (0,
    1) and sample other pixels)."""

    def __init__(self, channels: int, out_channels: int | None = None,
                 **factory):
        super().__init__()
        self.op = nn.Conv2d(channels, out_channels or channels, 3, stride=2,
                            padding=1, **factory)

    def forward(self, x):
        return self.op(x)
