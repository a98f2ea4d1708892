"""Diffusion samplers: Euler-EDM as a Python loop over the steps.

Counterpart of ``multiview_inpaint_tpu/diffusion/samplers.py``
``euler_edm_sample`` (the reference's EulerEDMSampler, the paper's
25-step inference sampler): gamma-churn Euler over the Karras ladder, the
denoiser composed with a guider's prepare/combine. The initial noise is
the caller's ``x``; the churn noise comes from ``generator`` and is drawn
only at steps whose gamma is above 0 (none at ``s_churn=0``, the default).
The other samplers wait for a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .guiders import IdentityGuider


def _bdims(s, x):
    return s.reshape(s.shape + (1,) * (x.ndim - 1))


def prepare_x(x, sigmas):
    """The reference's prepare_sampling_loop scaling: x *= sqrt(1+s0^2)."""
    return x * torch.sqrt(1.0 + sigmas[0] ** 2)


def gammas(n: int, sigmas, s_churn: float, s_tmin: float,
           s_tmax: float) -> list:
    """Per-step churn gamma (host floats) for an ``n``-step ladder."""
    g = min(s_churn / max(n - 1, 1), 2 ** 0.5 - 1)
    return [g if s_tmin <= float(s) <= s_tmax else 0.0
            for s in sigmas[:-1].tolist()]


def euler_edm_sample(denoise_fn: Callable, x: torch.Tensor, cond: Dict,
                     uc: Optional[Dict], sigmas: torch.Tensor,
                     guider=IdentityGuider(),
                     generator: Optional[torch.Generator] = None,
                     s_churn: float = 0.0, s_tmin: float = 0.0,
                     s_tmax: float = float("inf"),
                     s_noise: float = 1.0) -> torch.Tensor:
    """``denoise_fn(x, sigma_vec, cond) -> denoised``; ``sigmas`` [n+1]
    descending and ending in 0, on x's device."""
    uc = cond if uc is None else uc
    x = prepare_x(x, sigmas)
    b = x.shape[0]
    n = sigmas.shape[0] - 1
    for i, gamma in enumerate(gammas(n, sigmas, s_churn, s_tmin, s_tmax)):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        sigma_hat = sigma * (gamma + 1.0)
        if gamma > 0:
            eps = torch.randn(x.shape, generator=generator, device=x.device,
                              dtype=x.dtype) * s_noise
            x = x + eps * torch.sqrt(torch.clamp(
                sigma_hat ** 2 - sigma ** 2, min=0.0))
        s_vec = sigma_hat.to(x.dtype).expand(b)
        gx, gs, gc = guider.prepare(x, s_vec, cond, uc)
        denoised = guider.combine(denoise_fn(gx, gs, gc), s_vec)
        d = (x - denoised) / _bdims(s_vec, x)
        x = x + (next_sigma - sigma_hat) * d
    return x
