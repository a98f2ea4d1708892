"""Diffusion samplers as Python loops over the steps.

Counterpart of ``multiview_inpaint_tpu/diffusion/samplers.py``:

- ``euler_edm_sample`` (the reference's EulerEDMSampler, the paper's
  25-step inference sampler): gamma-churn Euler over the Karras ladder.
  The churn noise comes from ``generator`` and is drawn only at steps
  whose gamma is above 0 (none at ``s_churn=0``, the default).
- ``dpmpp2m_sample``: DPM-Solver++(2M), deterministic multistep.
- ``unipc_sample``: UniPC of order 2 (bh2, x0 prediction), the diffusers
  ``UniPCMultistepScheduler`` defaults that ``ctrl_inpaint`` uses, in
  Karras sigma space.

Each composes the denoiser with a guider's prepare/combine; the initial
noise is the caller's ``x``. The multistep samplers pick each step's
branch on the host (the JAX scans select with ``jnp.where``) and do the
step's arithmetic on 0-dim f32 tensors, in the JAX order. The other
samplers wait for a later slice.
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


def _guided_denoise(denoise_fn, guider, x, sigma, cond, uc):
    s_vec = sigma.to(x.dtype).expand(x.shape[0])
    gx, gs, gc = guider.prepare(x, s_vec, cond, uc)
    return guider.combine(denoise_fn(gx, gs, gc), s_vec)


def _lam(s):
    """lambda = -log sigma (sigma floored at 1e-10)."""
    return -torch.log(torch.clamp(s, min=1e-10))


def _nz(v):
    return torch.where(v == 0, torch.ones_like(v), v)


def dpmpp2m_sample(denoise_fn: Callable, x: torch.Tensor, cond: Dict,
                   uc: Optional[Dict], sigmas: torch.Tensor,
                   guider=IdentityGuider()) -> torch.Tensor:
    """DPM-Solver++(2M); ``sigmas`` [n+1] f32, descending, ending in 0."""
    uc = cond if uc is None else uc
    x = prepare_x(x, sigmas)
    old_denoised, prev_sigma = None, None
    for i in range(sigmas.shape[0] - 1):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        denoised = _guided_denoise(denoise_fn, guider, x, sigma, cond, uc)
        h = _lam(next_sigma) - _lam(sigma)
        if prev_sigma is not None and float(next_sigma) > 0:
            h_last = _lam(sigma) - _lam(prev_sigma)
            r = h_last / _nz(h)
            denoised_d = ((1 + 1 / (2 * r)) * denoised
                          - (1 / (2 * r)) * old_denoised)
        else:
            denoised_d = denoised
        x = (next_sigma / sigma) * x - torch.expm1(-h) * denoised_d
        old_denoised, prev_sigma = denoised, sigma
    return x


def unipc_sample(denoise_fn: Callable, x: torch.Tensor, cond: Dict,
                 uc: Optional[Dict], sigmas: torch.Tensor,
                 guider=IdentityGuider()) -> torch.Tensor:
    """UniPC, order 2, bh2, x0 prediction, in Karras sigma space (alpha
    1, lambda = -log sigma). Each step's model evaluation at the
    predicted point first corrects the previous update (uni_c, order 1
    at step 1, 2 from step 2), then the predictor advances from the
    corrected sample (uni_p; order 2 from step 1, where at bh2 it is
    DPM-Solver++(2M)). ``sigmas`` as for ``dpmpp2m_sample``."""
    uc = cond if uc is None else uc
    x = prepare_x(x, sigmas)
    last_x, m1, m2, s1, s2 = x, None, None, None, None
    for i in range(sigmas.shape[0] - 1):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        m0 = _guided_denoise(denoise_fn, guider, x, sigma, cond, uc)
        if i >= 1:                                   # uni_c
            hc = _lam(sigma) - _lam(s1)
            bhc = torch.expm1(-hc)
            x_c = (sigma / _nz(s1)) * last_x - bhc * m1
            d1_t = m0 - m1
            if i >= 2:
                r0 = (_lam(s2) - _lam(s1)) / _nz(hc)
                d1s0 = (m2 - m1) / _nz(r0)
                hphi_k1 = bhc / _nz(-hc) - 1.0
                b1 = hphi_k1 / _nz(bhc)
                hphi_k2 = hphi_k1 / _nz(-hc) - 0.5
                b2 = 2.0 * hphi_k2 / _nz(bhc)
                rho1 = (b1 - b2) / _nz(1.0 - r0)
                rho2 = (b2 - r0 * b1) / _nz(1.0 - r0)
                x = x_c - bhc * (rho1 * d1s0 + rho2 * d1_t)
            else:
                x = x_c - bhc * 0.5 * d1_t
        h = _lam(next_sigma) - _lam(sigma)           # uni_p
        bh = torch.expm1(-h)
        x_next = (next_sigma / _nz(sigma)) * x - bh * m0
        if float(next_sigma) != 0 and i >= 1:
            rp = (_lam(s1) - _lam(sigma)) / _nz(h)
            x_next = x_next - bh * 0.5 * ((m1 - m0) / _nz(rp))
        last_x, x = x, x_next
        m1, m2, s1, s2 = m0, m1, sigma, s1
    return x
