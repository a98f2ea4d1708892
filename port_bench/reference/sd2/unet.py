"""The SD-2-inpainting UNet, plain PyTorch in float32.

Follows Stability-AI/stablediffusion
``configs/stable-diffusion/v2-inpainting-inference.yaml`` (``UNetModel``:
``in_channels`` 9 = noisy latents 4 | mask 1 | masked latents 4,
``out_channels`` 4, ``model_channels`` 320, ``channel_mult`` 1-2-4-4, 2
res blocks a level, attention at ds 1, 2, 4, ``num_head_channels`` 64,
``transformer_depth`` 1, ``context_dim`` 1024, ``use_linear_in_transformer``)
on ``reference/svd``'s ResBlock, transformer block and layers. Inputs and
outputs are NHWC; the blocks run NCHW. Parameter names are the
checkpoint's (``input_blocks.N.M``, ``middle_block.N``,
``output_blocks.N.M``, ``time_embed.N``, ``out.N``).

Departures from the published model, all inherited from the blocks it
reuses (which follow the JAX package, as the program does): LayerNorm
eps 1e-6 (published 1e-5), GEGLU's gate through the tanh-approximate
GELU (published exact), attention logits and softmax in float32 in
blocks of query rows. The text context is an input (the published model
takes OpenCLIP ViT-H/14's penultimate layer).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..svd.layers import (Downsample, GroupNorm32, Upsample,
                          timestep_embedding, zero_)
from ..svd.resblock import ResBlock
from ..svd.transformer import BasicTransformerBlock


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 9
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024


class SpatialTransformer(nn.Module):
    """GroupNorm32, linear ``proj_in``, the blocks over the H*W tokens,
    ``proj_out`` and the residual."""

    def __init__(self, ch: int, heads: int, d_head: int, depth: int,
                 context_dim: Optional[int], **factory):
        super().__init__()
        inner = heads * d_head
        self.norm = GroupNorm32(ch, **factory)
        self.proj_in = nn.Linear(ch, inner, **factory)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, d_head, context_dim,
                                  **factory) for _ in range(depth))
        self.proj_out = zero_(nn.Linear(inner, ch, **factory))

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(
            b, h * w, c))
        for block in self.transformer_blocks:
            t = block(t, context)
        return self.proj_out(t).reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class Block(nn.Sequential):
    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig(), **factory):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.model_channels
        ted = ch0 * 4
        hd = cfg.num_head_channels

        def attn(ch):
            return SpatialTransformer(ch, ch // hd, hd, cfg.transformer_depth,
                                      cfg.context_dim, **factory)

        self.time_embed = nn.Sequential(
            nn.Linear(ch0, ted, **factory), nn.SiLU(),
            nn.Linear(ted, ted, **factory))
        self.input_blocks = nn.ModuleList([Block(
            nn.Conv2d(cfg.in_channels, ch0, 3, padding=1, **factory))])
        chans, ch, ds = [ch0], ch0, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [ResBlock(ch, ted, mult * ch0, **factory)]
                ch = mult * ch0
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(Block(*layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(Block(Downsample(ch, **factory)))
                chans.append(ch)
                ds *= 2
        self.middle_block = Block(ResBlock(ch, ted, ch, **factory), attn(ch),
                                  ResBlock(ch, ted, ch, **factory))
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), ted, mult * ch0,
                                   **factory)]
                ch = mult * ch0
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch, **factory))
                    ds //= 2
                self.output_blocks.append(Block(*layers))
        self.out = nn.Sequential(
            GroupNorm32(ch0, **factory), nn.SiLU(),
            zero_(nn.Conv2d(ch0, cfg.out_channels, 3, padding=1, **factory)))

    def forward(self, x, timesteps, context):
        """x [B, H, W, 9], timesteps [B] float, context [B, L, D] ->
        eps [B, H, W, 4]."""
        emb = self.time_embed(timestep_embedding(
            timesteps, self.cfg.model_channels).to(x.dtype))
        h = x.permute(0, 3, 1, 2)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h).permute(0, 2, 3, 1)
