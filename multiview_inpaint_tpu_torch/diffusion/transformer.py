"""Transformer blocks of the diffusion UNet (PyTorch).

Counterpart of ``multiview_inpaint_tpu/diffusion/transformer.py`` and the
reference's ``sgm/modules/attention.py`` (CrossAttention, GEGLU
FeedForward, BasicTransformerBlock) and ``video_attention.py``
(VideoTransformerBlock, SpatialVideoTransformer), all on the one
attention op (``attention_op.attention``). Parameter names are the
reference's (``to_q``, ``to_out.0``, ``ff.net.0.proj``, ``ff.net.2``,
``norm1``, ``time_stack.0``, ``time_pos_embed.0`` ...).

As in the JAX package: LayerNorm eps 1e-6 (flax's default), GEGLU's gate
through the tanh-approximate GELU (``jax.nn.gelu``'s default), and
``SpatialVideoTransformer`` takes and returns [(b t), C, H, W].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .attention_op import attention
from .layers import AlphaBlender, GroupNorm32, timestep_embedding, zero_

LN_EPS = 1e-6


def _ln(dim, **factory):
    return nn.LayerNorm(dim, eps=LN_EPS, **factory)


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, **factory):
        super().__init__()
        inner = heads * dim_head
        ctx = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False, **factory)
        self.to_k = nn.Linear(ctx, inner, bias=False, **factory)
        self.to_v = nn.Linear(ctx, inner, bias=False, **factory)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim, **factory))

    def forward(self, x, context=None):
        ctx = x if context is None else context
        out = attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                        self.heads)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, **factory):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2, **factory)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, dim_out: int, mult: int = 4, **factory):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner, **factory), nn.Identity(),
                                 nn.Linear(inner, dim_out, **factory))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None,
                 disable_self_attn: bool = False, **factory):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.attn1 = CrossAttention(
            dim, context_dim if disable_self_attn else None, n_heads, d_head,
            **factory)
        self.ff = FeedForward(dim, dim, **factory)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head,
                                    **factory)
        self.norm1 = _ln(dim, **factory)
        self.norm2 = _ln(dim, **factory)
        self.norm3 = _ln(dim, **factory)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x), context if self.disable_self_attn
                       else None) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class VideoTransformerBlock(nn.Module):
    """Temporal transformer over the frame axis (``(b s) t c`` inside)."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None, ff_in: bool = True,
                 **factory):
        super().__init__()
        if ff_in:
            self.norm_in = _ln(dim, **factory)
            self.ff_in = FeedForward(dim, dim, **factory)
        else:
            self.ff_in = None
        self.attn1 = CrossAttention(dim, None, n_heads, d_head, **factory)
        self.ff = FeedForward(dim, dim, **factory)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head,
                                    **factory)
        self.norm1 = _ln(dim, **factory)
        self.norm2 = _ln(dim, **factory)
        self.norm3 = _ln(dim, **factory)

    def forward(self, x, context=None, timesteps: int = 1):
        b_t, s, c = x.shape
        b = b_t // timesteps
        # (b t) s c -> (b s) t c
        x = x.reshape(b, timesteps, s, c).transpose(1, 2).reshape(
            b * s, timesteps, c)
        if self.ff_in is not None:
            x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        x = self.ff(self.norm3(x)) + x
        # (b s) t c -> (b t) s c
        return x.reshape(b, s, timesteps, c).transpose(1, 2).reshape(
            b_t, s, c)


class SpatialVideoTransformer(nn.Module):
    """Spatial attention + temporal ``time_stack`` with an AlphaBlender
    merge, always ``use_linear`` (the SVD configuration)."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 use_spatial_context: bool = True,
                 merge_strategy: str = "learned_with_images",
                 ff_in: bool = True, max_time_embed_period: int = 10000,
                 **factory):
        super().__init__()
        inner = n_heads * d_head
        self.in_channels = in_channels
        self.use_spatial_context = use_spatial_context
        self.max_time_embed_period = max_time_embed_period
        self.norm = GroupNorm32(in_channels, **factory)
        self.proj_in = nn.Linear(in_channels, inner, **factory)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim,
                                  **factory) for _ in range(depth))
        self.time_stack = nn.ModuleList(
            VideoTransformerBlock(inner, n_heads, d_head,
                                  context_dim if use_spatial_context
                                  else None, ff_in=ff_in, **factory)
            for _ in range(depth))
        self.time_pos_embed = nn.Sequential(
            nn.Linear(in_channels, in_channels * 4, **factory), nn.SiLU(),
            nn.Linear(in_channels * 4, in_channels, **factory))
        self.time_mixer = AlphaBlender(merge_strategy=merge_strategy,
                                       **factory)
        self.proj_out = zero_(nn.Linear(inner, in_channels, **factory))

    def forward(self, x, context=None, timesteps: int = 1,
                image_only_indicator=None):
        b_t, c, h, w = x.shape
        x_in = x
        time_context = None
        if self.use_spatial_context and context is not None:
            # The temporal blocks see frame 0's context, once per position.
            time_context = torch.repeat_interleave(context[::timesteps],
                                                   h * w, dim=0)
        x = self.norm(x).permute(0, 2, 3, 1).reshape(b_t, h * w, c)
        x = self.proj_in(x)
        frames = torch.arange(timesteps, device=x.device).repeat(
            b_t // timesteps)
        t_emb = timestep_embedding(frames, self.in_channels,
                                   self.max_time_embed_period).to(x.dtype)
        emb = self.time_pos_embed(t_emb)[:, None, :]
        for block, mix_block in zip(self.transformer_blocks,
                                    self.time_stack):
            x = block(x, context)
            x_mix = mix_block(x + emb, time_context, timesteps)
            x = self.time_mixer(x, x_mix, image_only_indicator)
        x = self.proj_out(x)
        return x.reshape(b_t, h, w, c).permute(0, 3, 1, 2) + x_in
