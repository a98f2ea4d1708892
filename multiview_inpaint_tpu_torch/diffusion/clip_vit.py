"""OpenCLIP-style vision transformer for image conditioning (PyTorch).

Counterpart of ``multiview_inpaint_tpu/diffusion/clip_vit.py`` (the
reference's ``FrozenOpenCLIPImageEmbedder``): the ViT-H/14 visual tower,
14x14 patch conv, class token, learned positional embedding, pre-LN
transformer (width 1280, 32 layers, 16 heads), post-LN and a linear
projection to 1024, returning the pooled class-token embedding. Inputs
are in [-1, 1]; the tower maps them to [0, 1], resizes to 224 with JAX's
antialiased Keys bicubic (``resize_bicubic``) and CLIP-normalises.
``resize_bilinear`` is ``jax.image.resize(..., "bilinear")``, as the
grounder resizes its window crops.

Parameter names are OpenCLIP's (``conv1``, ``class_embedding``,
``positional_embedding``, ``ln_pre``, ``transformer.resblocks.N.{ln_1,
attn.in_proj_weight, attn.in_proj_bias, attn.out_proj, ln_2, mlp.c_fc,
mlp.c_proj}``, ``ln_post``, ``proj``). The attention is plain matmul +
softmax (logits in f32, or in f64 for f64 inputs; an optional mask as
flax applies it, for the causal text tower). As in the JAX package, the
tower computes in the type of its input whatever type its weights are
stored in (the engine stores them in bf16 and feeds f32 frames, so it
runs in f32 on bf16-rounded weights), with LayerNorm eps 1e-6 and the
exact GELU.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .. import telemetry

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    output_dim: int = 1024


TINY_VIT = ViTConfig(image_size=224, patch_size=32, width=64, layers=2,
                     heads=2, output_dim=64)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _resize_weights(n_in: int, n_out: int, device,
                    kernel=_keys_cubic, antialias: bool = True
                    ) -> torch.Tensor:
    """[n_in, n_out] weights of ``jax.image.resize`` along one axis
    (``scale_and_translate``: half-pixel centres, ``kernel`` widened by the
    downscale factor unless ``antialias`` is off, columns normalised):
    ``_keys_cubic`` for "bicubic", ``_triangle`` for "bilinear"."""
    inv_scale = 1.0 / (n_out / n_in)   # as JAX rounds it
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
              ) * inv_scale - 0.5
    pos = torch.arange(n_in, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - pos[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x: torch.Tensor, size, kernel,
            antialias: bool = True) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C]; an axis whose size does not change is
    left as it is, as ``jax.image.resize`` leaves it. Differentiable: the
    backward applies the same weights transposed."""
    for axis, n_out in ((1, size[0]), (2, size[1])):
        n_in = x.shape[axis]
        if n_in != n_out:
            w = _resize_weights(n_in, n_out, x.device, kernel,
                                antialias).to(x.dtype)
            x = torch.tensordot(x.movedim(axis, -1), w, dims=1).movedim(
                -1, axis)
    return x


def resize_bicubic(x: torch.Tensor, size) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C], as ``jax.image.resize`` bicubic."""
    return _resize(x, size, _keys_cubic)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C], as ``jax.image.resize`` bilinear (a
    triangle kernel, antialiased when shrinking)."""
    return _resize(x, size, _triangle)


def _linear(mod: nn.Linear, x):
    return F.linear(x, mod.weight.to(x.dtype),
                    None if mod.bias is None else mod.bias.to(x.dtype))


def _layer_norm(mod: nn.LayerNorm, x):
    return F.layer_norm(x, mod.normalized_shape, mod.weight.to(x.dtype),
                        mod.bias.to(x.dtype), mod.eps)


class MultiheadSelfAttention(nn.Module):
    """Self-attention with OpenCLIP's packed parameters: ``in_proj_weight``
    [3W, W], ``in_proj_bias`` [3W] and ``out_proj``."""

    def __init__(self, width: int, heads: int, **factory):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width,
                                                       **factory))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, **factory))
        self.out_proj = nn.Linear(width, width, **factory)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, mask=None):
        """``mask`` [n, n] bool (True: attend), as flax masks: the logits
        it drops take the type's lowest value."""
        b, n, w = x.shape
        d = w // self.heads
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype),
                       self.in_proj_bias.to(x.dtype))
        q, k, v = (t.reshape(b, n, self.heads, d).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        acc = torch.promote_types(x.dtype, torch.float32)
        s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * d ** -0.5
        if mask is not None:
            s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        out = torch.matmul(p, v).transpose(1, 2).reshape(b, n, w)
        return _linear(self.out_proj, out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, **factory):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS, **factory)
        self.attn = MultiheadSelfAttention(width, heads, **factory)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS, **factory)
        self.mlp = nn.Module()
        self.mlp.c_fc = nn.Linear(width, width * 4, **factory)
        self.mlp.c_proj = nn.Linear(width * 4, width, **factory)

    def forward(self, x, mask=None):
        x = x + self.attn(_layer_norm(self.ln_1, x), mask)
        h = F.gelu(_linear(self.mlp.c_fc, _layer_norm(self.ln_2, x)))
        return x + _linear(self.mlp.c_proj, h)


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: ViTConfig = ViTConfig(), **factory):
        super().__init__()
        self.cfg = cfg
        gh = cfg.image_size // cfg.patch_size
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch_size,
                               stride=cfg.patch_size, bias=False, **factory)
        self.class_embedding = nn.Parameter(
            0.02 * torch.randn(cfg.width, **factory))
        self.positional_embedding = nn.Parameter(
            0.02 * torch.randn(gh * gh + 1, cfg.width, **factory))
        self.ln_pre = nn.LayerNorm(cfg.width, eps=LN_EPS, **factory)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads, **factory)
            for _ in range(cfg.layers))
        self.ln_post = nn.LayerNorm(cfg.width, eps=LN_EPS, **factory)
        self.proj = nn.Parameter(
            0.02 * torch.randn(cfg.width, cfg.output_dim, **factory))

    def forward(self, x):
        """x [B, H, W, 3] in [-1, 1] -> pooled [B, output_dim], in x's
        type."""
        cfg = self.cfg
        b, dt = x.shape[0], x.dtype
        x = resize_bicubic((x + 1.0) / 2.0, (cfg.image_size, cfg.image_size))
        with telemetry.host_read():     # blocking copies to the card
            mean = torch.tensor(CLIP_MEAN, dtype=dt, device=x.device)
            std = torch.tensor(CLIP_STD, dtype=dt, device=x.device)
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        h = F.conv2d(x, self.conv1.weight.to(dt),
                     stride=cfg.patch_size).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(dt)[None, None].expand(b, 1, -1)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(dt)
        h = _layer_norm(self.ln_pre, h)
        for blk in self.transformer.resblocks:
            h = blk(h)
        pooled = _layer_norm(self.ln_post, h[:, 0])
        return pooled @ self.proj.to(dt)
