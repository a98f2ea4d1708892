"""UNet residual blocks: 2D spatial and factorised temporal (PyTorch).

Counterpart of ``multiview_inpaint_tpu/diffusion/resblock.py`` and of the
reference's ``openaimodel.py`` ResBlock and ``video_model.py``
VideoResBlock: GroupNorm32 + SiLU + conv in and out, the timestep
embedding's projection added between them, a zero-initialised output
conv, a 1x1 skip on a channel change; the temporal stack is a 3D ResBlock
with a (3, 1, 1) kernel over (T, H, W) merged by a learned AlphaBlender.

Layout: ``ResBlock`` takes [N, C, H, W] (dims=2) or [B, C, T, H, W]
(dims=3) with ``emb`` [N, E] or [B, T, E]; ``VideoResBlock`` takes the
time-in-batch [(b t), C, H, W] of the UNet. Parameter names are the
reference's (``in_layers.0``, ``in_layers.2``, ``emb_layers.1``,
``out_layers.0``, ``out_layers.3``, ``skip_connection``, ``time_stack``,
``time_mixer``).
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from .layers import AlphaBlender, GroupNorm32, zero_


def _conv(dims, cin, cout, kernel, **factory):
    if dims == 2:
        return nn.Conv2d(cin, cout, kernel, padding=kernel // 2, **factory)
    kernel = tuple(kernel)
    return nn.Conv3d(cin, cout, kernel, padding=tuple(k // 2 for k in kernel),
                     **factory)


class ResBlock(nn.Module):
    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 dims: int = 2, kernel_size=3, **factory):
        super().__init__()
        self.dims = dims
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, **factory), nn.SiLU(),
            _conv(dims, channels, out_channels, kernel_size, **factory))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, out_channels, **factory))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels, **factory), nn.SiLU(), nn.Identity(),
            zero_(_conv(dims, out_channels, out_channels, kernel_size,
                        **factory)))
        self.skip_connection = (
            nn.Identity() if channels == out_channels else
            _conv(dims, channels, out_channels,
                  1 if dims == 2 else (1, 1, 1), **factory))

    def forward(self, x, emb):
        h = self.in_layers(x)
        e = self.emb_layers(emb)
        if self.dims == 2:
            h = h + e[:, :, None, None]
        else:                                   # emb [B, T, C] per frame
            h = h + e.permute(0, 2, 1)[:, :, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class VideoResBlock(ResBlock):
    """Spatial ResBlock + (3, 1, 1) temporal ResBlock, AlphaBlender mix."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 video_kernel_size: Sequence[int] = (3, 1, 1),
                 merge_strategy: str = "learned_with_images", **factory):
        super().__init__(channels, emb_channels, out_channels, **factory)
        self.time_stack = ResBlock(out_channels, emb_channels, out_channels,
                                   dims=3, kernel_size=video_kernel_size,
                                   **factory)
        self.time_mixer = AlphaBlender(merge_strategy=merge_strategy,
                                       **factory)

    def forward(self, x, emb, num_video_frames: int,
                image_only_indicator=None):
        x = super().forward(x, emb)                      # [(b t), C, H, W]
        bt, c, hh, ww = x.shape
        b = bt // num_video_frames
        x5 = x.reshape(b, num_video_frames, c, hh, ww).permute(0, 2, 1, 3, 4)
        h = self.time_stack(x5, emb.reshape(b, num_video_frames, -1))
        h = h.permute(0, 2, 1, 3, 4).reshape(bt, c, hh, ww)
        return self.time_mixer(x, h, image_only_indicator)
