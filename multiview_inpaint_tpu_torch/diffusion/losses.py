"""Diffusion training losses.

Counterpart of ``multiview_inpaint_tpu/diffusion/losses.py`` (the
reference's ``sgm/modules/diffusionmodules/loss.py``):

- :func:`standard_diffusion_loss`: StandardDiffusionLoss (one sigma per
  sample, weighted L1/L2 against the clean latents);
- :func:`inpaint_diffusion_loss`: InpaintDiffusionLoss, one sigma per
  *video* repeated over its frames, and optionally the InpaintDiffusionLoss2
  warp-consistency term;
- :func:`warp_consistency_loss`: gathers each denoised frame at ``uv_ind``
  (the pixels of the next frame that project into it through the coarse
  depth) and penalises the masked difference to the next frame.

The denoiser is injected as ``denoise_fn(noised, sigmas, cond)``. The
random draws are injectable: ``sigmas`` (per sample, or per video for the
inpaint loss) and ``noise`` (a standard normal of the latents' shape);
what is not given is drawn from ``generator``. The JAX functions split a
key instead; the tests reproduce its draws and inject them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import edm

WEIGHTINGS = {
    "edm": edm.edm_weighting,
    "v": edm.v_weighting,
    "eps": edm.eps_weighting,
    "unit": edm.unit_weighting,
}


def _bdims(s, x):
    return s.reshape(s.shape + (1,) * (x.ndim - 1))


def _per_sample(loss_type: str, model_output, target, w):
    diff = model_output - target
    if loss_type == "l2":
        e = w * diff * diff
    elif loss_type == "l1":
        e = w * diff.abs()
    else:
        raise NotImplementedError(loss_type)
    return e.reshape(target.shape[0], -1).mean(dim=1)


def _weights(weighting: str, sigmas, sigma_data: float):
    if weighting == "edm":
        return edm.edm_weighting(sigmas, sigma_data)
    return WEIGHTINGS[weighting](sigmas)


def draws(n, shape, dtype, device, p_mean: float = 1.0, p_std: float = 1.6,
          sigmas=None, noise=None, generator=None):
    """The loss's random draws, in its order: ``n`` sigmas, then a
    standard normal ``noise`` of ``shape``, each drawn from ``generator``
    unless given."""
    if sigmas is None:
        sigmas = edm.edm_sigma_sample((n,), p_mean, p_std,
                                      generator=generator, device=device)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device,
                            dtype=dtype)
    return sigmas.to(device), noise.to(device)


def standard_diffusion_loss(denoise_fn: Callable, latents: torch.Tensor,
                            cond: Dict, loss_type: str = "l2",
                            weighting: str = "edm", sigma_data: float = 1.0,
                            p_mean: float = 1.0, p_std: float = 1.6,
                            sigmas: Optional[torch.Tensor] = None,
                            noise: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None):
    """Per-sample losses ``[B]``; ``sigmas`` ``[B]``."""
    sigmas, noise = draws(latents.shape[0], latents.shape, latents.dtype,
                          latents.device, p_mean, p_std, sigmas, noise,
                          generator)
    noised = latents + noise * _bdims(sigmas, latents)
    out = denoise_fn(noised, sigmas, cond)
    w = _weights(weighting, sigmas, sigma_data)
    return _per_sample(loss_type, out, latents, _bdims(w, latents))


def inpaint_diffusion_loss(denoise_fn: Callable, latents: torch.Tensor,
                           cond: Dict, num_video_frames: int,
                           loss_type: str = "l2", weighting: str = "edm",
                           sigma_data: float = 1.0, p_mean: float = 1.0,
                           p_std: float = 1.6, warp: Optional[Dict] = None,
                           sigmas: Optional[torch.Tensor] = None,
                           noise: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None):
    """Per-frame losses ``[(b t)]`` of latents ``[(b t), h, w, c]`` with
    one sigma per video (``sigmas`` ``[b]``).

    ``warp``: optional ``{"hit_map": [(b), t-1, h, w], "uv_ind": [(b), t-1,
    c, h*w]}`` adding the InpaintDiffusionLoss2 warp-consistency term, video
    by video."""
    bt = latents.shape[0]
    b = bt // num_video_frames
    sig_b, noise = draws(b, latents.shape, latents.dtype, latents.device,
                         p_mean, p_std, sigmas, noise, generator)
    sig = torch.repeat_interleave(sig_b, num_video_frames)
    noised = latents + noise * _bdims(sig, latents)
    out = denoise_fn(noised, sig, cond)
    w_bc = _bdims(_weights(weighting, sig, sigma_data), latents)
    loss = _per_sample(loss_type, out, latents, w_bc)
    if warp is not None:
        t = num_video_frames
        hit = warp["hit_map"].reshape((b, t - 1) + out.shape[1:3])
        uv = warp["uv_ind"].reshape(b, t - 1, out.shape[3], -1)
        loss = loss + torch.cat([
            warp_consistency_loss(out[i * t:(i + 1) * t], hit[i], uv[i],
                                  w_bc[i * t:(i + 1) * t], loss_type)
            for i in range(b)])
    return loss


def warp_consistency_loss(model_output: torch.Tensor, hit_map: torch.Tensor,
                          uv_ind: torch.Tensor, w_bc: torch.Tensor,
                          loss_type: str = "l2") -> torch.Tensor:
    """Cross-frame consistency on one video's denoised latents.

    model_output ``[t, h, w, c]``; uv_ind flat indices into each previous
    frame's h*w grid per channel; hit_map ``[t-1, h, w]``. Returns per-frame
    additions ``[t]``, zero for frame 0."""
    t, h, w, c = model_output.shape
    prev = model_output[:t - 1].permute(0, 3, 1, 2).reshape(t - 1, c, h * w)
    ind = uv_ind.reshape(t - 1, c, h * w).long()
    projected = torch.gather(prev, -1, ind).reshape(
        t - 1, c, h, w).permute(0, 2, 3, 1)
    err = (projected - model_output[1:]) * hit_map[..., None]
    e = w_bc[1:] * (err * err if loss_type == "l2" else err.abs())
    add = e.reshape(t - 1, -1).mean(dim=1)
    return torch.cat([add.new_zeros(1), add])
