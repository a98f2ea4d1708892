"""KL autoencoder: spatial Encoder/Decoder + temporal VideoDecoder (PyTorch).

Counterpart of ``multiview_inpaint_tpu/diffusion/vae.py`` and the
reference's ``sgm/modules/diffusionmodules/model.py`` (Encoder, Decoder,
ResnetBlock with GroupNorm eps 1e-6, single-head AttnBlock) and
``autoencoding/temporal_ae.py`` (VideoDecoder with ``time_mode``
"conv-only": every decoder ResnetBlock gains a (3, 1, 1) temporal stack
mixed by a learned scalar initialised to 0, and ``conv_out`` gains a
temporal ``time_mix_conv``). Config: ch 128, ch_mult (1, 2, 4, 4), 2 res
blocks, z 4 (the encoder writes mean and log-variance, 8 channels), mid
attention only. ``VideoAttnBlock`` (time modes "all" and "attn-only") is
not instantiated at the shipped configuration and is not ported yet.

Public functions take and return the JAX package's NHWC layout; the
blocks run NCHW inside. The attention is plain matmul + softmax.
Parameter names are the reference's (``encoder.down.N.block.M``,
``decoder.up.N.upsample.conv``, ``decoder.mid.block_1.time_stack``,
``decoder.conv_out.time_mix_conv`` ...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import zero_


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    out_ch: int = 3
    double_z: bool = True
    video_kernel_size: Tuple[int, ...] = (3, 1, 1)


def _gn(c, eps=1e-6, **factory):
    return nn.GroupNorm(32 if c % 32 == 0 else c, c, eps=eps, **factory)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, **factory):
        super().__init__()
        self.norm1 = _gn(in_channels, **factory)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               **factory)
        self.norm2 = _gn(out_channels, **factory)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               **factory)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1,
                                          **factory)
        else:
            self.nin_shortcut = None

    def forward(self, x, timesteps: int = 1):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class _TimeStack(nn.Module):
    """The reference's skip-t-emb 3D ResBlock: GroupNorm (eps 1e-5) + SiLU
    + (3, 1, 1) conv, twice, the second conv zero-initialised."""

    def __init__(self, c: int, kernel: Sequence[int], **factory):
        super().__init__()
        pad = tuple(k // 2 for k in kernel)
        self.in_layers = nn.Sequential(
            _gn(c, 1e-5, **factory), nn.SiLU(),
            nn.Conv3d(c, c, tuple(kernel), padding=pad, **factory))
        self.out_layers = nn.Sequential(
            _gn(c, 1e-5, **factory), nn.SiLU(), nn.Identity(),
            zero_(nn.Conv3d(c, c, tuple(kernel), padding=pad, **factory)))

    def forward(self, x):
        return self.out_layers(self.in_layers(x))


class VideoResnetBlock(ResnetBlock):
    """ResnetBlock + (3, 1, 1) temporal stack, learned alpha (init 0)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int] = (3, 1, 1), **factory):
        super().__init__(in_channels, out_channels, **factory)
        self.time_stack = _TimeStack(out_channels, kernel, **factory)
        self.mix_factor = nn.Parameter(torch.zeros(
            1, device=factory.get("device"),
            dtype=factory.get("dtype") or torch.float32))

    def forward(self, x, timesteps: int = 1):
        x = super().forward(x)
        bt, c, hh, ww = x.shape
        x5 = x.reshape(bt // timesteps, timesteps, c, hh, ww).permute(
            0, 2, 1, 3, 4)
        h = x5 + self.time_stack(x5)
        a = torch.sigmoid(self.mix_factor)[0]
        out = a * h + (1.0 - a) * x5
        return out.permute(0, 2, 1, 3, 4).reshape(bt, c, hh, ww)


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W positions (1x1 convs q, k,
    v, proj_out; plain matmul + softmax) with the residual."""

    def __init__(self, c: int, **factory):
        super().__init__()
        self.norm = _gn(c, **factory)
        self.q = nn.Conv2d(c, c, 1, **factory)
        self.k = nn.Conv2d(c, c, 1, **factory)
        self.v = nn.Conv2d(c, c, 1, **factory)
        self.proj_out = nn.Conv2d(c, c, 1, **factory)

    def forward(self, x, timesteps: int = 1):
        b, c, h, w = x.shape
        hn = self.norm(x)

        def flat(t):
            return t.permute(0, 2, 3, 1).reshape(b, h * w, c)

        q, k, v = flat(self.q(hn)), flat(self.k(hn)), flat(self.v(hn))
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2))
                             * (c ** -0.5), dim=-1)
        out = torch.matmul(attn, v).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.proj_out(out)


class _Level(nn.Module):
    """One resolution level: ``block`` and ``downsample``/``upsample``."""

    def __init__(self, blocks, resample_name: Optional[str] = None,
                 resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample_name is not None:
            setattr(self, resample_name, resample)


class _Resample(nn.Module):
    def __init__(self, c: int, stride: int, **factory):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=stride,
                              padding=0 if stride == 2 else 1, **factory)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig(), **factory):
        super().__init__()
        self.cfg = cfg
        self.conv_in = nn.Conv2d(3, cfg.ch, 3, padding=1, **factory)
        self.down = nn.ModuleList()
        cin = cfg.ch
        for level, mult in enumerate(cfg.ch_mult):
            cout = cfg.ch * mult
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(cin, cout, **factory))
                cin = cout
            last = level == len(cfg.ch_mult) - 1
            self.down.append(_Level(
                blocks, None if last else "downsample",
                None if last else _Resample(cout, 2, **factory)))
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(cin, cin, **factory)
        self.mid.attn_1 = AttnBlock(cin, **factory)
        self.mid.block_2 = ResnetBlock(cin, cin, **factory)
        self.norm_out = _gn(cin, **factory)
        self.conv_out = nn.Conv2d(
            cin, cfg.z_channels * (2 if cfg.double_z else 1), 3, padding=1,
            **factory)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                # asymmetric pad (0, 1) then the stride-2 conv, as the
                # reference
                h = level.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class AE3DConv(nn.Conv2d):
    """The VideoDecoder's ``conv_out``: a 2D conv, then a temporal conv
    (``time_mix_conv``) over the frames."""

    def __init__(self, cin: int, cout: int, video_kernel_size, **factory):
        super().__init__(cin, cout, 3, padding=1, **factory)
        k = tuple(video_kernel_size)
        self.time_mix_conv = nn.Conv3d(cout, cout, k,
                                       padding=tuple(i // 2 for i in k),
                                       **factory)

    def forward(self, x, timesteps: int = 1):
        h = super().forward(x)
        bt, c, hh, ww = h.shape
        h5 = h.reshape(bt // timesteps, timesteps, c, hh, ww).permute(
            0, 2, 1, 3, 4)
        h5 = self.time_mix_conv(h5)
        return h5.permute(0, 2, 1, 3, 4).reshape(bt, c, hh, ww)


class Decoder(nn.Module):
    """Decoder; ``video=True`` is the VideoDecoder in "conv-only" mode."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), video: bool = False,
                 **factory):
        super().__init__()
        self.cfg = cfg
        self.video = video

        def res(cin, cout):
            if video:
                return VideoResnetBlock(cin, cout, cfg.video_kernel_size,
                                        **factory)
            return ResnetBlock(cin, cout, **factory)

        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, ch, 3, padding=1, **factory)
        self.mid = nn.Module()
        self.mid.block_1 = res(ch, ch)
        self.mid.attn_1 = AttnBlock(ch, **factory)
        self.mid.block_2 = res(ch, ch)
        levels = {}
        for level in reversed(range(len(cfg.ch_mult))):
            cout = cfg.ch * cfg.ch_mult[level]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(res(ch, cout))
                ch = cout
            levels[level] = _Level(
                blocks, "upsample" if level else None,
                _Resample(cout, 1, **factory) if level else None)
        self.up = nn.ModuleList(levels[i] for i in range(len(cfg.ch_mult)))
        self.norm_out = _gn(ch, **factory)
        self.conv_out = (AE3DConv(ch, cfg.out_ch, cfg.video_kernel_size,
                                  **factory) if video else
                         nn.Conv2d(ch, cfg.out_ch, 3, padding=1, **factory))

    def forward(self, z, timesteps: int = 1):
        h = self.conv_in(z)
        h = self.mid.block_1(h, timesteps)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h, timesteps)
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h, timesteps)
            if hasattr(level, "upsample"):
                h = level.upsample.conv(F.interpolate(h, scale_factor=2.0,
                                                      mode="nearest"))
        h = F.silu(self.norm_out(h))
        if self.video:
            return self.conv_out(h, timesteps)
        return self.conv_out(h)


class DiagonalGaussian:
    """Posterior from the encoder's (mean, logvar) split (NHWC)."""

    def __init__(self, params: torch.Tensor):
        self.mean, logvar = params.chunk(2, dim=-1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std * ``noise`` (a standard normal of the mean's shape,
        injected so that tests can feed both packages the same draws)."""
        return self.mean + self.std * noise

    def mode(self):
        return self.mean


class AutoencoderKL(nn.Module):
    """Encoder + (Video)Decoder with the quant / post-quant 1x1 convs.
    Latents are not scaled here (the engine applies 0.18215)."""

    def __init__(self, cfg: VAEConfig = VAEConfig(),
                 video_decoder: bool = True, **factory):
        super().__init__()
        self.cfg = cfg
        zc = cfg.z_channels
        self.encoder = Encoder(cfg, **factory)
        self.decoder = Decoder(cfg, video=video_decoder, **factory)
        self.quant_conv = nn.Conv2d(2 * zc if cfg.double_z else zc,
                                    2 * zc if cfg.double_z else zc, 1,
                                    **factory)
        self.post_quant_conv = nn.Conv2d(zc, zc, 1, **factory)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """x [B, H, W, 3] NHWC in [-1, 1] -> the posterior (NHWC)."""
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return DiagonalGaussian(h.permute(0, 2, 3, 1))

    def decode(self, z: torch.Tensor, timesteps: int = 1) -> torch.Tensor:
        """z [(b t), h, w, 4] NHWC -> [(b t), H, W, 3] NHWC."""
        h = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)),
                         timesteps)
        return h.permute(0, 2, 3, 1)

    def forward(self, x, timesteps: int = 1):
        post = self.encode(x)
        return self.decode(post.mode(), timesteps), post
