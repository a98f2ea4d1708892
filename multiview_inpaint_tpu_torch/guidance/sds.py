"""Score-distillation (SDS) guidance with an inpainting diffusion prior.

Counterpart of ``multiview_inpaint_tpu/guidance/sds.py`` (the reference's
``gs-simp/guidance/sdi_utils.py``, the Stable-Diffusion-2-inpainting SDS
that grows the coarse object geometry):

- the scaled-linear DDPM schedule (0.00085 ... 0.012, 1000 steps), t drawn
  from [0.02, 0.98] x 1000;
- the 9-channel UNet input [noisy latents (4) | mask (1) | masked latents
  (4)] and classifier-free guidance at scale 100;
- the SDS loss 0.5 ||latents - sg(latents - w (eps_hat - eps))||^2 / B
  with w(t) = 1 - alpha_bar_t, whose gradient w (eps_hat - eps) flows into
  the image through the VAE encoder (``train_step``);
- ``test_step``: a DDIM denoise from a chosen t, for visualisation.

The prior is injected as ``eps_model(x9, t, text_emb) -> eps`` and VAE
``encode``/``decode`` functions over NHWC tensors. The eps model and the
encoding of the masked image run under ``torch.no_grad()`` (the JAX step's
``stop_gradient``): no graph is kept through the UNet, and its long
self-attention takes the flash-attention forward without its backward.

The draws come from a ``torch.Generator`` (JAX's ``jax.random`` keys
cannot be reproduced); ``train_step`` takes ``t`` and ``noise`` as given
instead, so that tests can pass JAX's draws in.

Spans (``telemetry``): ``sds.encode`` around each of the step's two
encodes (the differentiable one and the masked one), ``sds.prior``
around each CFG evaluation (``_eps_cfg``, counted as
``sds.prior_evals``), and ``host_read`` where, on a device's first
step, the schedule is copied to the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .. import telemetry
from ..diffusion.edm import ddpm_alphas_cumprod


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    num_steps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012

    def alphas_cumprod(self, device=None) -> torch.Tensor:
        return ddpm_alphas_cumprod(self.num_steps, self.beta_start,
                                   self.beta_end, device)


@dataclasses.dataclass(frozen=True)
class SDSConfig:
    guidance_scale: float = 100.0
    t_range: Tuple[float, float] = (0.02, 0.98)
    schedule: DDPMSchedule = DDPMSchedule()


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """[..., H, W] -> [..., h, w] as ``jax.image.resize(..., "nearest")``:
    output pixel i samples input floor((i + 0.5) in / out), computed in
    f32 as JAX computes it (half-pixel centres, torch's
    ``nearest-exact``). The indices are made on ``x``'s device, so the
    host waits on no copy; ``n`` divides as a tensor, since CUDA turns a
    division by a host scalar into a product with its reciprocal."""
    for axis, n in ((-2, size[0]), (-1, size[1])):
        m = x.shape[axis]
        if m != n:
            i = torch.arange(n, dtype=torch.float32, device=x.device)
            den = torch.full((), n, dtype=torch.float32, device=x.device)
            idx = torch.floor((i + 0.5) * m / den).long()
            x = torch.index_select(x, x.dim() + axis, idx)
    return x


class SDSGuidance:
    """SDS with an inpainting eps model.

    Args:
      eps_model: (x9 [B, h, w, 9], t [B] f32, text_emb [B, L, D]) ->
        eps [B, h, w, 4]; ``_eps_cfg`` builds the (uncond | cond) batch.
      vae_encode: images [B, H, W, 3] in [0, 1] -> latents [B, h, w, 4]
        (differentiable).
      vae_decode: latents -> images in [0, 1].
    """

    def __init__(self, eps_model: Callable, vae_encode: Callable,
                 vae_decode: Callable, cfg: SDSConfig = SDSConfig()):
        self.eps_model = eps_model
        self.vae_encode = vae_encode
        self.vae_decode = vae_decode
        self.cfg = cfg
        self._acp = {}

    def acp(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._acp:
            with telemetry.host_read():  # the first call's copy to the card
                self._acp[device] = self.cfg.schedule.alphas_cumprod(device)
        return self._acp[device]

    def _eps_cfg(self, x9, t, text_embs):
        """text_embs [2, L, D] = (uncond, cond); CFG at guidance_scale."""
        telemetry.count("sds.prior_evals")
        with telemetry.span("sds.prior"):
            b = x9.shape[0]
            x2 = torch.cat([x9, x9], dim=0)
            t2 = torch.cat([t, t], dim=0)
            emb = torch.cat([text_embs[0:1].expand(b, -1, -1),
                             text_embs[1:2].expand(b, -1, -1)], dim=0)
            eps_u, eps_c = self.eps_model(x2, t2, emb).chunk(2, dim=0)
            return eps_u + self.cfg.guidance_scale * (eps_c - eps_u)

    def t_bounds(self) -> Tuple[int, int]:
        n = self.cfg.schedule.num_steps
        return (int(self.cfg.t_range[0] * n), int(self.cfg.t_range[1] * n))

    def train_step(self, image: torch.Tensor, mask: torch.Tensor,
                   text_embs: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """SDS loss of one rendered view.

        image [H, W, 3] in [0, 1] (the gradient flows); mask [H, W] (1 =
        inpaint); text_embs [2, L, D]. ``t`` [1] (int) and ``noise`` (the
        latents' shape) are drawn from ``generator`` unless given.
        Returns the scalar loss whose gradient w.r.t. ``image`` is the SDS
        gradient."""
        dev = image.device
        img = image[None]
        with telemetry.span("sds.encode"):
            latents = self.vae_encode(img)
        h, w = latents.shape[1:3]
        mask_l = resize_nearest(mask, (h, w))[None, :, :, None]
        keep = 1.0 - mask[None, ..., None]
        with torch.no_grad(), telemetry.span("sds.encode"):
            masked_latents = self.vae_encode(img * keep)
        if t is None:
            tmin, tmax = self.t_bounds()
            t = torch.randint(tmin, tmax + 1, (1,), generator=generator,
                              device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=dev)
        t = t.to(dev)
        acp = self.acp(dev)[t].reshape(-1, 1, 1, 1)
        with torch.no_grad():
            noisy = (torch.sqrt(acp) * latents.detach()
                     + torch.sqrt(1 - acp) * noise)
            x9 = torch.cat([noisy, mask_l, masked_latents], dim=-1)
            eps_hat = self._eps_cfg(x9, t.float(), text_embs)
            grad = (1.0 - acp) * (eps_hat - noise)
            target = latents.detach() - grad
        return 0.5 * torch.sum((latents - target) ** 2) / latents.shape[0]

    @torch.no_grad()
    def test_step(self, image: torch.Tensor, mask: torch.Tensor,
                  text_embs: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  start_t: float = 0.98, num_steps: int = 25,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DDIM denoise from ``start_t`` (``sdi_utils.test_step``); the
        start noise is drawn from ``generator`` unless given."""
        dev = image.device
        img = image[None]
        latents = self.vae_encode(img)
        h, w = latents.shape[1:3]
        mask_l = resize_nearest(mask, (h, w))[None, :, :, None]
        masked_latents = self.vae_encode(img * (1 - mask[None, ..., None]))
        acp = self.acp(dev)
        t0 = int(start_t * self.cfg.schedule.num_steps)
        ts = torch.linspace(t0, 1, num_steps, dtype=torch.float32).to(
            torch.int32).tolist()
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=dev)
        x = torch.sqrt(acp[t0]) * latents + torch.sqrt(1 - acp[t0]) * noise
        one = torch.ones((), device=dev)
        for i, t_cur in enumerate(ts):
            t_next = ts[i + 1] if i + 1 < num_steps else 0
            x9 = torch.cat([x, mask_l, masked_latents], dim=-1)
            eps = self._eps_cfg(x9, torch.full((1,), float(t_cur),
                                               device=dev), text_embs)
            a_cur = acp[t_cur]
            a_next = acp[t_next] if t_next > 0 else one
            x0 = (x - torch.sqrt(1 - a_cur) * eps) / torch.sqrt(a_cur)
            x = torch.sqrt(a_next) * x0 + torch.sqrt(1 - a_next) * eps
        return torch.clamp(self.vae_decode(x)[0], 0.0, 1.0)
