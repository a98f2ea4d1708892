"""VideoUNet, the SVD denoising backbone (PyTorch).

Counterpart of ``multiview_inpaint_tpu/diffusion/unet.py`` and the
reference's ``video_model.py`` VideoUNet at the SVD configuration: in 8
channels (4 latent + 4 conditioning-frame concat), model 320, out 4,
``channel_mult`` (1, 2, 4, 4), 2 res blocks per level, attention at ds
{1, 2, 4} with heads = ch / 64, context 1024, adm 768. The time axis rides
the batch: inputs are [(b t), H, W, C] (the JAX package's NHWC layout at
this public boundary) with ``num_video_frames`` and
``image_only_indicator`` [b, t]. Inside, the blocks run NCHW on a
channels-last view of the same memory.

``control`` (the ControlledVideoUNet of the reference) is the list of 13
ControlNet residuals added to the middle output and each decoder skip;
``extract_features=True`` returns every encoder and middle hidden state
(the ControlNet's trunk); ``hint`` is added after the input conv.
Parameter names are the reference's (``input_blocks.N.M``,
``middle_block.N``, ``output_blocks.N.M``, ``time_embed.N``,
``label_emb.0.N``, ``out.N``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from .layers import Downsample, GroupNorm32, Upsample, timestep_embedding, \
    zero_
from .resblock import VideoResBlock
from .transformer import SpatialVideoTransformer


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    adm_in_channels: int = 768
    video_kernel_size: Tuple[int, ...] = (3, 1, 1)
    merge_strategy: str = "learned_with_images"
    # The reference zero-initialises the final output conv, which makes a
    # random-init net's output identically zero; False gives it a small
    # normal init instead (the JAX package's random-init training runs).
    out_zero_init: bool = True


class TimestepEmbedSequential(nn.Sequential):
    """One UNet block: a VideoResBlock, a SpatialVideoTransformer, a
    Downsample or an Upsample (or a conv), each called with what it
    takes."""

    def forward(self, x, emb, context, num_video_frames,
                image_only_indicator):
        for layer in self:
            if isinstance(layer, VideoResBlock):
                x = layer(x, emb, num_video_frames, image_only_indicator)
            elif isinstance(layer, SpatialVideoTransformer):
                x = layer(x, context, num_video_frames, image_only_indicator)
            else:
                x = layer(x)
        return x


class VideoUNet(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig(), encoder_only=False,
                 **factory):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.model_channels
        ted = ch0 * 4

        def res(cin, cout):
            return VideoResBlock(cin, ted, cout, cfg.video_kernel_size,
                                 cfg.merge_strategy, **factory)

        def attn(ch):
            return SpatialVideoTransformer(
                ch, ch // cfg.num_head_channels, cfg.num_head_channels,
                depth=cfg.transformer_depth, context_dim=cfg.context_dim,
                merge_strategy=cfg.merge_strategy, **factory)

        self.time_embed = nn.Sequential(
            nn.Linear(ch0, ted, **factory), nn.SiLU(),
            nn.Linear(ted, ted, **factory))
        self.label_emb = nn.Sequential(nn.Sequential(
            nn.Linear(cfg.adm_in_channels, ted, **factory), nn.SiLU(),
            nn.Linear(ted, ted, **factory)))

        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(
            nn.Conv2d(cfg.in_channels, ch0, 3, padding=1, **factory))])
        chans = [ch0]
        ch, ds = ch0, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, mult * ch0)]
                ch = mult * ch0
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(
                    Downsample(ch, **factory)))
                chans.append(ch)
                ds *= 2
        self.middle_block = TimestepEmbedSequential(res(ch, ch), attn(ch),
                                                    res(ch, ch))
        self.feature_channels = chans + [ch]
        if encoder_only:
            return

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * ch0)]
                ch = mult * ch0
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch, **factory))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        out_conv = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1, **factory)
        if cfg.out_zero_init:
            zero_(out_conv)
        else:
            with torch.no_grad():
                out_conv.weight.normal_(0.0, 0.02)
                out_conv.bias.zero_()
        self.out = nn.Sequential(GroupNorm32(ch0, **factory), nn.SiLU(),
                                 out_conv)

    def embed(self, timesteps, y, dtype):
        """The time (+ label) embedding [(b t), 4 ch0] in ``dtype``."""
        t_emb = timestep_embedding(timesteps, self.cfg.model_channels)
        emb = self.time_embed(t_emb.to(dtype))
        if y is not None:
            emb = emb + self.label_emb(y.to(dtype))
        return emb

    def forward(self, x, timesteps, context=None, y=None,
                num_video_frames: int = 1, image_only_indicator=None,
                control: Optional[List[torch.Tensor]] = None,
                extract_features: bool = False,
                hint: Optional[torch.Tensor] = None):
        """x [(b t), H, W, C_in] (NHWC); ``hint`` and each ``control``
        residual NHWC as well. Returns [(b t), H, W, C_out], or with
        ``extract_features`` the list of NHWC hidden states."""
        emb = self.embed(timesteps, y, x.dtype)
        args = (emb, context, num_video_frames, image_only_indicator)
        h = self.input_blocks[0](x.permute(0, 3, 1, 2), *args)
        if hint is not None:
            h = h + hint.permute(0, 3, 1, 2)
        hs = [h]
        for block in self.input_blocks[1:]:
            h = block(h, *args)
            hs.append(h)
        h = self.middle_block(h, *args)
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
            h = block(torch.cat([h, skip], dim=1), *args)
        return self.out(h).permute(0, 2, 3, 1)
