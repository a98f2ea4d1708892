"""The SD-2-inpainting prior and its SDS loss, plain PyTorch.

The KL encoder is ``reference/svd``'s (``vae.Encoder`` and the 1x1
``quant_conv``; config ch 128, mult 1-2-4-4, 2 res blocks, z 4 with
``double_z``, mid attention only), taking images in [0, 1] to [-1, 1]
and returning the posterior's mean scaled by 0.18215. The SDS loss is
``sdi_utils.train_step``'s: the DDPM scaled-linear schedule (betas from
0.00085 to 0.012 on a ramp of their square roots, 1000 steps, the
cumulative product in float64 rounded once to float32), the 9-channel
input [noisy latents | mask | masked latents], classifier-free guidance
over the (unconditional | conditional) batch, w(t) = 1 - alpha_bar_t,
and 0.5 ||z - sg(z - w (eps_hat - eps))||^2 / B, whose gradient
w (eps_hat - eps) reaches the image through the encoder. The mask is
shrunk by the half-pixel nearest rule (``jax.image.resize`` "nearest").
``t`` and ``eps`` are inputs: the draws of ``t`` in [20, 980] and of the
noise are the caller's.

``dtype=torch.bfloat16`` is the control: the UNet and the encoder with
bfloat16 parameters and activations (GroupNorm32's statistics in
float32); the loss and the schedule stay float32.
"""

from __future__ import annotations

import torch
from torch import nn

from ..svd.vae import Encoder, VAEConfig
from .unet import UNet, UNetConfig

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
LATENT_SCALE = 0.18215


def alphas_cumprod(n: int = 1000, start: float = 0.00085,
                   end: float = 0.012, device=None) -> torch.Tensor:
    betas = torch.linspace(start ** 0.5, end ** 0.5, n,
                           dtype=torch.float64) ** 2
    return torch.cumprod(1.0 - betas, 0).float().to(device)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """[H, W] -> [h, w]: output pixel i takes input floor((i + 0.5) in /
    out), in float32."""
    for axis, n in ((0, size[0]), (1, size[1])):
        m = x.shape[axis]
        if m != n:
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * m / n).long().to(x.device)
            x = torch.index_select(x, axis, idx)
    return x


class KLEncoder(nn.Module):
    """The KL autoencoder's encoding half, under its checkpoint names."""

    def __init__(self, cfg: VAEConfig = VAEConfig(), **factory):
        super().__init__()
        self.encoder = Encoder(cfg, **factory)
        zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.quant_conv = nn.Conv2d(zc, zc, 1, **factory)
        self.z = cfg.z_channels

    def forward(self, img01):
        """[B, H, W, 3] in [0, 1] -> scaled latents [B, H/8, W/8, 4]."""
        x = (img01 * 2 - 1).permute(0, 3, 1, 2)
        h = self.quant_conv(self.encoder(x))
        return h[:, :self.z].permute(0, 2, 3, 1) * LATENT_SCALE


class Prior(nn.Module):
    def __init__(self, unet_cfg: UNetConfig, vae_cfg: VAEConfig,
                 guidance_scale: float, **factory):
        super().__init__()
        self.unet = UNet(unet_cfg, **factory)
        self.kl = KLEncoder(vae_cfg, **factory)
        self.guidance_scale = guidance_scale

    @property
    def dtype(self):
        return self.unet.time_embed[0].weight.dtype

    def load(self, sd: dict) -> None:
        """Strict load from checkpoint-keyed weights (the VAE's decoder
        entries are not used here)."""
        self.unet.load_state_dict({k[len(UNET_PREFIX):]: v
                                   for k, v in sd.items()
                                   if k.startswith(UNET_PREFIX)})
        own = set(self.kl.state_dict())
        self.kl.load_state_dict({k[len(VAE_PREFIX):]: v
                                 for k, v in sd.items()
                                 if k[len(VAE_PREFIX):] in own
                                 and k.startswith(VAE_PREFIX)})

    def encode(self, img01):
        return self.kl(img01.to(self.dtype)).float()

    def eps_cfg(self, x9, t, text_embs):
        b = x9.shape[0]
        emb = torch.cat([text_embs[0:1].expand(b, -1, -1),
                         text_embs[1:2].expand(b, -1, -1)])
        eps = self.unet(torch.cat([x9, x9]).to(self.dtype),
                        torch.cat([t, t]).float(),
                        emb.to(self.dtype)).float()
        eps_u, eps_c = eps.chunk(2)
        return eps_u + self.guidance_scale * (eps_c - eps_u)

    def sds_loss(self, image, mask, text_embs, t, noise):
        """The SDS loss of image [H, W, 3] in [0, 1] (the gradient flows)
        under mask [H, W] (1 = inpaint), text_embs [2, L, D] (uncond,
        cond), t [1] int and noise of the latents' shape."""
        img = image[None]
        latents = self.encode(img)
        h, w = latents.shape[1:3]
        with torch.no_grad():
            mask_l = resize_nearest(mask, (h, w))[None, :, :, None]
            masked = self.encode(img * (1.0 - mask[None, ..., None]))
            acp = alphas_cumprod(device=img.device)[t].reshape(-1, 1, 1, 1)
            noisy = (torch.sqrt(acp) * latents.detach()
                     + torch.sqrt(1 - acp) * noise)
            x9 = torch.cat([noisy, mask_l, masked], dim=-1)
            eps_hat = self.eps_cfg(x9, t, text_embs)
            target = latents.detach() - (1.0 - acp) * (eps_hat - noise)
        return 0.5 * torch.sum((latents - target) ** 2) / latents.shape[0]

    def image_grad(self, image, mask, text_embs, t, noise):
        """The SDS loss's gradient with respect to ``image``."""
        x = image.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(self.sds_loss(x, mask, text_embs, t,
                                                 noise), x)
        return g


def weight_spec(unet_cfg: UNetConfig, vae_cfg: VAEConfig) -> list:
    """[(key, shape)] of the UNet's and the whole KL autoencoder's weights
    (its decoder too), in the checkpoint's key space, built on the meta
    device."""
    from ..svd.vae import AutoencoderKL
    with torch.device("meta"):
        unet = UNet(unet_cfg)
        vae = AutoencoderKL(vae_cfg, video_decoder=False)
    return ([(UNET_PREFIX + k, tuple(v.shape))
             for k, v in unet.state_dict().items()]
            + [(VAE_PREFIX + k, tuple(v.shape))
               for k, v in vae.state_dict().items()])
