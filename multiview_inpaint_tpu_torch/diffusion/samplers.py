"""Diffusion samplers as Python loops over the steps.

Counterpart of ``multiview_inpaint_tpu/diffusion/samplers.py`` (the
reference's ``sampling.py``), every sampler of it:

- ``euler_edm_sample`` (EulerEDMSampler, the paper's 25-step inference
  sampler): gamma-churn Euler over the Karras ladder;
- ``heun_edm_sample``: EDM's Heun correction, skipped on the step to 0;
- ``euler_edm_sample_blended`` (EulerEDMSampler2): each step renoises the
  background latents z to the step's sigma and blends them in through the
  mask (1 keeps the sampled region);
- ``euler_edm_sample_inversion`` (EulerEDMSampler3): a DDIM-style
  inversion of z up the ladder with the exact (sigma^2 + 1) rescaling,
  then blended resampling against the inverted latent of each step;
- ``euler_ancestral_sample`` and ``dpmpp2s_ancestral_sample``: the
  ancestral (sigma_down, sigma_up) split, Euler or the DPM-Solver++(2S)
  midpoint step, then fresh noise;
- ``dpmpp2m_sample`` (DPM-Solver++(2M)), ``unipc_sample`` (UniPC of order
  2, bh2, x0 prediction, the diffusers ``UniPCMultistepScheduler``
  defaults that ``ctrl_inpaint`` uses) and ``lms_sample`` (linear
  multistep over the sigma grid; ``_lms_coeff_matrix`` integrates the
  Lagrange basis exactly in float64): deterministic multistep.

Each composes the denoiser with a guider's prepare/combine; the initial
noise is the caller's ``x``. Each step picks its branch on the host (the
JAX scans compute both and select with ``jnp.where``, so the port skips
the denoiser calls whose result JAX throws away) and does its arithmetic
on 0-dim f32 tensors in the JAX order.

Random draws: JAX splits a key per step; its draws cannot be made in
torch. A stochastic sampler draws each standard normal from
``generator`` where the step uses it, or takes them as given, one tensor
per step and kind, in JAX's order: ``churn`` (the gamma-churn noise, used
only where gamma > 0), ``renoise`` (the blended background noise) and
``ancestral`` (the ancestral noise, used where the next sigma is above 0).

Latent dump: ``set_latent_debug_hook(hook)`` makes every sampler call
``hook(tag, sigma, x)`` once per step with host (numpy) copies of the
step's sigma and its updated latent; ``LatentDumper`` and ``latent_dump``
write them as ``.npy`` files (the reference EDMSampler3's ``np.save``
calls). Without a hook nothing is copied.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from .guiders import IdentityGuider

Draws = Optional[Sequence[torch.Tensor]]

_debug_hook: Optional[Callable] = None


def set_latent_debug_hook(hook: Optional[Callable]):
    """``hook(tag: str, sigma, x)`` is called once per sampler step with
    the post-update latent (host numpy arrays). Returns the previous
    hook."""
    global _debug_hook
    prev, _debug_hook = _debug_hook, hook
    return prev


def _emit(tag: str, sigma: torch.Tensor, x: torch.Tensor) -> None:
    if _debug_hook is not None:
        _debug_hook(tag, sigma.detach().cpu().numpy(),
                    x.detach().cpu().numpy())


class LatentDumper:
    """Writes ``{prefix}_{i:03d}_{tag}.npy`` per sampler step plus a
    ``{prefix}_sigmas.npy`` ladder on close."""

    def __init__(self, out_dir: str, prefix: str = "latent"):
        self.out_dir = out_dir
        self.prefix = prefix
        self.i = 0
        self.sigmas = []
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, tag, sigma, x):
        np.save(os.path.join(self.out_dir,
                             f"{self.prefix}_{self.i:03d}_{tag}.npy"),
                np.asarray(x))
        self.sigmas.append(float(sigma))
        self.i += 1

    def close(self):
        np.save(os.path.join(self.out_dir, f"{self.prefix}_sigmas.npy"),
                np.asarray(self.sigmas))


@contextlib.contextmanager
def latent_dump(out_dir: str, prefix: str = "latent"):
    """Context manager: dump every sampler step's latent to ``out_dir``."""
    dumper = LatentDumper(out_dir, prefix)
    prev = set_latent_debug_hook(dumper)
    try:
        yield dumper
    finally:
        set_latent_debug_hook(prev)
        dumper.close()


def _bdims(s, x):
    return s.reshape(s.shape + (1,) * (x.ndim - 1))


def _normal(draws: Draws, i: int, like: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Step i's standard normal of ``like``'s shape: the given one, or a
    draw from ``generator``."""
    if draws is not None:
        return draws[i].to(like.device, like.dtype)
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=like.dtype)


def prepare_x(x, sigmas):
    """The reference's prepare_sampling_loop scaling: x *= sqrt(1+s0^2)."""
    return x * torch.sqrt(1.0 + sigmas[0] ** 2)


def gammas(n: int, sigmas, s_churn: float, s_tmin: float,
           s_tmax: float) -> list:
    """Per-step churn gamma for an ``n``-step ladder, each a 0-dim f32
    tensor on the host (read without a device sync, and a scalar to the
    ladder's device): min(s_churn / max(n - 1, 1), sqrt 2 - 1) in f32 as
    JAX computes it, 0 outside [s_tmin, s_tmax]. Reading the ladder is
    one host read (a ``host_read`` span)."""
    g = torch.minimum(torch.tensor(s_churn, dtype=torch.float32)
                      / max(n - 1, 1),
                      torch.tensor(2 ** 0.5 - 1, dtype=torch.float32))
    zero = torch.zeros((), dtype=torch.float32)
    with telemetry.host_read():
        ladder = sigmas[:-1].tolist()
    return [g if s_tmin <= float(s) <= s_tmax else zero for s in ladder]


def _churn(x, sigma, gamma, draws, i, generator, s_noise):
    """(sigma_hat, x) after the step's gamma churn: sigma (gamma + 1), and
    x plus noise of the variance sigma_hat^2 - sigma^2 where gamma > 0."""
    sigma_hat = sigma * (gamma + 1.0)
    if float(gamma) > 0:
        eps = _normal(draws, i, x, generator) * s_noise
        x = x + eps * torch.sqrt(torch.clamp(
            sigma_hat ** 2 - sigma ** 2, min=0.0))
    return sigma_hat, x


def _guided_denoise(denoise_fn, guider, x, sigma, cond, uc):
    s_vec = sigma.to(x.dtype).expand(x.shape[0])
    gx, gs, gc = guider.prepare(x, s_vec, cond, uc)
    return guider.combine(denoise_fn(gx, gs, gc), s_vec)


def _euler_step(denoise_fn, guider, x, sigma_hat, next_sigma, cond, uc):
    denoised = _guided_denoise(denoise_fn, guider, x, sigma_hat, cond, uc)
    d = (x - denoised) / _bdims(sigma_hat.to(x.dtype).expand(x.shape[0]),
                                x)
    return x + (next_sigma - sigma_hat) * d


def euler_edm_sample(denoise_fn: Callable, x: torch.Tensor, cond: Dict,
                     uc: Optional[Dict], sigmas: torch.Tensor,
                     guider=IdentityGuider(),
                     generator: Optional[torch.Generator] = None,
                     s_churn: float = 0.0, s_tmin: float = 0.0,
                     s_tmax: float = float("inf"), s_noise: float = 1.0,
                     churn: Draws = None) -> torch.Tensor:
    """``denoise_fn(x, sigma_vec, cond) -> denoised``; ``sigmas`` [n+1]
    descending and ending in 0, on x's device."""
    uc = cond if uc is None else uc
    x = prepare_x(x, sigmas)
    n = sigmas.shape[0] - 1
    for i, gamma in enumerate(gammas(n, sigmas, s_churn, s_tmin, s_tmax)):
        sigma_hat, x = _churn(x, sigmas[i], gamma, churn, i, generator,
                              s_noise)
        x = _euler_step(denoise_fn, guider, x, sigma_hat, sigmas[i + 1],
                        cond, uc)
        _emit("euler", sigma_hat, x)
    return x


def heun_edm_sample(denoise_fn: Callable, x: torch.Tensor, cond: Dict,
                    uc: Optional[Dict], sigmas: torch.Tensor,
                    guider=IdentityGuider(),
                    generator: Optional[torch.Generator] = None,
                    s_churn: float = 0.0, s_tmin: float = 0.0,
                    s_tmax: float = float("inf"), s_noise: float = 1.0,
                    churn: Draws = None) -> torch.Tensor:
    """EDM Heun: the Euler step, then its trapezoidal correction from a
    second evaluation at the next sigma (not on the step to 0)."""
    uc = cond if uc is None else uc
    x = prepare_x(x, sigmas)
    b = x.shape[0]
    n = sigmas.shape[0] - 1
    for i, gamma in enumerate(gammas(n, sigmas, s_churn, s_tmin, s_tmax)):
        next_sigma = sigmas[i + 1]
        sigma_hat, x = _churn(x, sigmas[i], gamma, churn, i, generator,
                              s_noise)
        s_vec = sigma_hat.to(x.dtype).expand(b)
        denoised = _guided_denoise(denoise_fn, guider, x, sigma_hat, cond,
                                   uc)
        d = (x - denoised) / _bdims(s_vec, x)
        dt = next_sigma - sigma_hat
        x_e = x + dt * d
        if float(next_sigma) > 0:
            ns_vec = next_sigma.to(x.dtype).expand(b)
            den2 = _guided_denoise(denoise_fn, guider, x_e, next_sigma,
                                   cond, uc)
            d2 = (x_e - den2) / _bdims(ns_vec, x)
            x = x + dt * 0.5 * (d + d2)
        else:
            x = x_e
        _emit("heun", sigma_hat, x)
    return x


def euler_edm_sample_blended(denoise_fn: Callable, x: torch.Tensor,
                             cond: Dict, uc: Optional[Dict],
                             sigmas: torch.Tensor, z: torch.Tensor,
                             mask: torch.Tensor, guider=IdentityGuider(),
                             generator: Optional[torch.Generator] = None,
                             s_churn: float = 0.0, s_tmin: float = 0.0,
                             s_tmax: float = float("inf"),
                             s_noise: float = 1.0, churn: Draws = None,
                             renoise: Draws = None) -> torch.Tensor:
    """EulerEDMSampler2: before each step's evaluation the background
    latents ``z``, renoised to sigma_hat, replace x where ``mask`` is 0
    (1 keeps the sampled region)."""
    uc = cond if uc is None else uc
    x = prepare_x(x, sigmas)
    n = sigmas.shape[0] - 1
    for i, gamma in enumerate(gammas(n, sigmas, s_churn, s_tmin, s_tmax)):
        sigma_hat, x = _churn(x, sigmas[i], gamma, churn, i, generator,
                              s_noise)
        noised_z = z + _normal(renoise, i, z, generator) * sigma_hat
        x = x * mask + noised_z * (1.0 - mask)
        x = _euler_step(denoise_fn, guider, x, sigma_hat, sigmas[i + 1],
                        cond, uc)
        _emit("blended", sigma_hat, x)
    return x


def euler_edm_sample_inversion(denoise_fn: Callable,
                               inv_denoise_fn: Callable, x: torch.Tensor,
                               cond: Dict, uc: Optional[Dict],
                               sigmas: torch.Tensor, z: torch.Tensor,
                               mask: torch.Tensor, guider=IdentityGuider(),
                               inv_guider=IdentityGuider(),
                               generator: Optional[torch.Generator] = None,
                               s_churn: float = 0.0, s_tmin: float = 0.0,
                               s_tmax: float = float("inf"),
                               s_noise: float = 1.0,
                               churn: Draws = None) -> torch.Tensor:
    """EulerEDMSampler3: DDIM-style inversion of the background latents
    ``z`` up the ladder (``inv_denoise_fn`` returns the raw network
    output, the reference's ``Denoiser.inv_sample``), with the exact
    (sigma^2 + 1) rescaling, then Euler resampling that blends in the
    inverted latent of each step's sigma where ``mask`` is 0.

    Both passes guide with ``inv_guider``; ``guider`` is not read (as in
    the JAX sampler, ``samplers.py:279-280``)."""
    uc = cond if uc is None else uc
    b = x.shape[0]
    up = torch.flip(sigmas, (0,))
    x_inv, inverted = z, []
    for sigma, next_sigma in zip(up[:-1], up[1:]):
        s_vec = next_sigma.to(x.dtype).expand(b)
        gx, gs, gc = inv_guider.prepare(x_inv, s_vec, cond, uc)
        denoised = inv_guider.combine(inv_denoise_fn(gx, gs, gc), s_vec)
        x_scale = (next_sigma ** 2 + 1) / (sigma * next_sigma + 1)
        y_scale = ((next_sigma - sigma) * torch.sqrt(next_sigma ** 2 + 1)
                   / (sigma * next_sigma + 1))
        x_inv = x_scale * x_inv + y_scale * denoised
        _emit("invert", next_sigma, x_inv)
        inverted.append(x_inv)
    inverted.reverse()       # step i resamples against sigmas[i]'s latent

    x = prepare_x(x, sigmas)
    n = sigmas.shape[0] - 1
    for i, gamma in enumerate(gammas(n, sigmas, s_churn, s_tmin, s_tmax)):
        sigma_hat, x = _churn(x, sigmas[i], gamma, churn, i, generator,
                              s_noise)
        x = x * mask + inverted[i] * (1.0 - mask)
        x = _euler_step(denoise_fn, inv_guider, x, sigma_hat, sigmas[i + 1],
                        cond, uc)
        _emit("inversion", sigma_hat, x)
    return x


def _ancestral_split(sigma, next_sigma, eta):
    """(sigma_down, sigma_up) of an ancestral step."""
    sigma_up = torch.minimum(
        next_sigma,
        eta * (next_sigma ** 2 * (sigma ** 2 - next_sigma ** 2)
               / torch.clamp(sigma ** 2, min=1e-12)) ** 0.5)
    sigma_down = torch.sqrt(torch.clamp(next_sigma ** 2 - sigma_up ** 2,
                                        min=0.0))
    return sigma_down, sigma_up


def euler_ancestral_sample(denoise_fn: Callable, x: torch.Tensor,
                           cond: Dict, uc: Optional[Dict],
                           sigmas: torch.Tensor, guider=IdentityGuider(),
                           generator: Optional[torch.Generator] = None,
                           eta: float = 1.0, s_noise: float = 1.0,
                           ancestral: Draws = None) -> torch.Tensor:
    """Euler ancestral: an Euler step to sigma_down, then noise of
    sigma_up (none on the step to 0)."""
    uc = cond if uc is None else uc
    x = prepare_x(x, sigmas)
    for i in range(sigmas.shape[0] - 1):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        sigma_down, sigma_up = _ancestral_split(sigma, next_sigma, eta)
        x = _euler_step(denoise_fn, guider, x, sigma, sigma_down, cond, uc)
        if float(next_sigma) > 0:
            noise = _normal(ancestral, i, x, generator) * s_noise
            x = x + noise * sigma_up
        _emit("ancestral", sigma, x)
    return x


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
        _emit("dpmpp2m", sigma, x)
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
        _emit("unipc", sigma, x)
    return x


def dpmpp2s_ancestral_sample(denoise_fn: Callable, x: torch.Tensor,
                             cond: Dict, uc: Optional[Dict],
                             sigmas: torch.Tensor, guider=IdentityGuider(),
                             generator: Optional[torch.Generator] = None,
                             eta: float = 1.0, s_noise: float = 1.0,
                             ancestral: Draws = None) -> torch.Tensor:
    """DPM-Solver++(2S) ancestral (the reference's
    DPMPP2SAncestralSampler): the ancestral split, a midpoint
    second-order step in t = -log sigma to sigma_down (two evaluations;
    an Euler step where sigma_down is 0), then noise of sigma_up (none on
    the step to 0)."""
    uc = cond if uc is None else uc
    x = prepare_x(x, sigmas)
    for i in range(sigmas.shape[0] - 1):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        sigma_down, sigma_up = _ancestral_split(sigma, next_sigma, eta)
        if float(sigma_down) > 0:
            denoised = _guided_denoise(denoise_fn, guider, x, sigma, cond,
                                       uc)
            h = torch.log(sigma) - torch.log(sigma_down)
            sigma_mid = torch.exp(-(-torch.log(sigma) + 0.5 * h))
            x2 = torch.exp(-0.5 * h) * x - torch.expm1(-0.5 * h) * denoised
            denoised2 = _guided_denoise(denoise_fn, guider, x2, sigma_mid,
                                        cond, uc)
            x = torch.exp(-h) * x - torch.expm1(-h) * denoised2
        else:
            x = _euler_step(denoise_fn, guider, x, sigma, sigma_down, cond,
                            uc)
        if float(next_sigma) > 0:
            noise = _normal(ancestral, i, x, generator) * s_noise
            x = x + noise * sigma_up
        _emit("dpmpp2s", sigma, x)
    return x


def _lms_coeff_matrix(sigmas, order: int) -> np.ndarray:
    """[num_steps, order] Adams-Bashforth coefficients over the sigma grid
    in float64: entry (i, j), paired with d_{i-j}, integrates the Lagrange
    basis polynomial of node i - j over [sigma_i, sigma_{i+1}] exactly
    with numpy polynomials (the reference's ``linear_multistep_coeff``
    uses scipy quad); columns from min(i + 1, order) on are 0 (warm-up)."""
    from numpy.polynomial import polynomial as npoly

    t = np.asarray(sigmas, np.float64)
    n = len(t) - 1
    out = np.zeros((n, order), np.float64)
    for i in range(n):
        cur = min(i + 1, order)
        for j in range(cur):
            roots = [t[i - k] for k in range(cur) if k != j]
            denom = np.prod([t[i - j] - t[i - k]
                             for k in range(cur) if k != j]) or 1.0
            anti = npoly.polyint(npoly.polyfromroots(roots) / denom)
            out[i, j] = (npoly.polyval(t[i + 1], anti)
                         - npoly.polyval(t[i], anti))
    return out


def lms_sample(denoise_fn: Callable, x: torch.Tensor, cond: Dict,
               uc: Optional[Dict], sigmas: torch.Tensor,
               guider=IdentityGuider(), order: int = 4) -> torch.Tensor:
    """Linear multistep (the reference's LinearMultistepSampler): x plus
    the last ``order`` derivative estimates weighted by
    ``_lms_coeff_matrix``, rounded to f32 once."""
    uc = cond if uc is None else uc
    x = prepare_x(x, sigmas)
    b = x.shape[0]
    coeffs = torch.from_numpy(_lms_coeff_matrix(
        sigmas.detach().cpu().numpy(), order)).to(x.device, x.dtype)
    ds = []                                     # newest first: d_i, d_i-1
    for i in range(sigmas.shape[0] - 1):
        sigma = sigmas[i]
        denoised = _guided_denoise(denoise_fn, guider, x, sigma, cond, uc)
        ds = [(x - denoised) / _bdims(sigma.to(x.dtype).expand(b), x)
              ] + ds[:order - 1]
        update = coeffs[i, 0] * ds[0]
        for j in range(1, len(ds)):
            update = update + coeffs[i, j] * ds[j]
        x = x + update
        _emit("lms", sigma, x)
    return x
