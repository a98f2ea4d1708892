"""2D text-conditioned UNet, the SD-inpainting backbone of SDS and of
``ctrl_inpaint`` (PyTorch).

Counterpart of ``multiview_inpaint_tpu/diffusion/unet2d.py``: the video
UNet's family without the temporal stacks, i.e. ``ResBlock`` (2D) and a
``SpatialTransformer`` (GroupNorm32, linear ``proj_in``, self- and
text-cross attention, zero-initialised ``proj_out``), 9 input channels
[noisy latents (4) | mask (1) | masked latents (4)] and 4 eps channels
out. The default config is SD-2-inpainting's (ch 320, mult (1, 2, 4, 4),
attention at ds {1, 2, 4}, heads = ch / ``num_head_channels``, context
1024). As in the JAX package, the head width is fixed at
``num_head_channels`` (64): an SD-1.5 checkpoint (8 heads of 40, 80, 160)
runs with 5, 10 and 20 heads of 64 here, as it does there.

``control`` is the ControlNet2D's list of residuals added to the middle
output and each decoder skip; ``extract_features=True`` returns every
encoder and middle hidden state (the ControlNet's trunk); ``hint`` is
added after the input conv. Inputs and outputs are NHWC (the JAX
package's layout); the blocks run NCHW inside. Parameter names are the
reference's (``input_blocks.N.M``, ``middle_block.N``,
``output_blocks.N.M``, ``time_embed.N``, ``out.N``), with the ResBlock
parameters at block level (no ``spatial`` level).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from .layers import Downsample, GroupNorm32, Upsample, timestep_embedding, \
    zero_
from .resblock import ResBlock
from .transformer import BasicTransformerBlock


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
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
    """[N, C, H, W] -> [N, C, H, W]: GroupNorm32, ``proj_in``, the
    transformer blocks over the H*W tokens, ``proj_out`` and the
    residual."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 **factory):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels, **factory)
        self.proj_in = nn.Linear(in_channels, inner, **factory)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim,
                                  **factory) for _ in range(depth))
        self.proj_out = zero_(nn.Linear(inner, in_channels, **factory))

    def forward(self, x, context=None):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(
            b, h * w, c))
        for block in self.transformer_blocks:
            t = block(t, context)
        t = self.proj_out(t)
        return t.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class Block(nn.Sequential):
    """One UNet block: a ResBlock, a SpatialTransformer, a Downsample or an
    Upsample (or the input conv), each called with what it takes."""

    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class UNet2D(nn.Module):
    def __init__(self, cfg: UNet2DConfig = UNet2DConfig(),
                 encoder_only: bool = False, **factory):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.model_channels
        ted = ch0 * 4

        def attn(ch):
            return SpatialTransformer(
                ch, ch // cfg.num_head_channels, cfg.num_head_channels,
                depth=cfg.transformer_depth, context_dim=cfg.context_dim,
                **factory)

        self.time_embed = nn.Sequential(
            nn.Linear(ch0, ted, **factory), nn.SiLU(),
            nn.Linear(ted, ted, **factory))
        self.input_blocks = nn.ModuleList([Block(
            nn.Conv2d(cfg.in_channels, ch0, 3, padding=1, **factory))])
        chans = [ch0]
        ch, ds = ch0, 1
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
        self.feature_channels = chans + [ch]
        if encoder_only:
            return
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

    def forward(self, x, timesteps, context=None,
                control: Optional[List[torch.Tensor]] = None,
                extract_features: bool = False,
                hint: Optional[torch.Tensor] = None):
        """x [B, H, W, C_in] (NHWC), timesteps [B], context [B, L, D];
        ``hint`` and each ``control`` residual NHWC. Returns [B, H, W,
        C_out], or with ``extract_features`` the list of NHWC hidden
        states."""
        t_emb = timestep_embedding(timesteps, self.cfg.model_channels)
        emb = self.time_embed(t_emb.to(x.dtype))
        h = self.input_blocks[0](x.permute(0, 3, 1, 2), emb, context)
        if hint is not None:
            h = h + hint.permute(0, 3, 1, 2)
        hs = [h]
        for block in self.input_blocks[1:]:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        if extract_features:
            return [f.permute(0, 2, 3, 1) for f in hs + [h]]
        ctrl = ([c.permute(0, 3, 1, 2) for c in control]
                if control is not None else None)
        if ctrl is not None:
            h = h + ctrl.pop()
        for block in self.output_blocks:
            skip = hs.pop()
            if ctrl is not None:
                skip = skip + ctrl.pop()
            h = block(torch.cat([h, skip], dim=1), emb, context)
        return self.out(h).permute(0, 2, 3, 1)
