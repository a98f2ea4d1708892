"""EDM math: the Karras sigma ladder, the legacy DDPM ladder, the denoiser
scalings, ``denoise`` and its raw form ``raw_net_out``, sigma sampling
and loss weighting.

Counterpart of ``multiview_inpaint_tpu/diffusion/edm.py`` (the
reference's ``discretizer.py`` EDMDiscretization(0.002, 700, rho 7),
``denoiser_scaling.py``, ``sigma_sampling.py`` EDMSampling (lognormal,
p_mean 1.0, p_std 1.6) and ``loss_weighting.py`` EDMWeighting(sigma_data
1)).
"""

from __future__ import annotations

import torch


def edm_sigmas(n: int, sigma_min: float = 0.002, sigma_max: float = 700.0,
               rho: float = 7.0, device=None) -> torch.Tensor:
    """n f32 sigmas, descending, on the Karras rho schedule (the samplers
    append the final 0)."""
    ramp = torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    min_r = sigma_min ** (1 / rho)
    max_r = sigma_max ** (1 / rho)
    return (max_r + ramp * (min_r - max_r)) ** rho


def ddpm_alphas_cumprod(num_timesteps: int = 1000,
                        linear_start: float = 0.00085,
                        linear_end: float = 0.012, device=None
                        ) -> torch.Tensor:
    """The scaled-linear DDPM schedule's cumulative alphas
    [num_timesteps]: betas on a linear ramp of their square roots, the
    running product of 1 - beta, computed in f64 and rounded once to f32
    (an f32 running product drifts by ~1e-6 relative over 1000
    factors)."""
    betas = torch.linspace(linear_start ** 0.5, linear_end ** 0.5,
                           num_timesteps, dtype=torch.float64) ** 2
    return torch.cumprod(1.0 - betas, 0).float().to(device)


def legacy_ddpm_sigmas(n: int, num_timesteps: int = 1000,
                       linear_start: float = 0.00085,
                       linear_end: float = 0.012, device=None
                       ) -> torch.Tensor:
    """n f32 sigmas sqrt((1 - acp) / acp), descending, sampled at n evenly
    rounded indices of the DDPM schedule (the reference's
    LegacyDDPMDiscretization)."""
    acp = ddpm_alphas_cumprod(num_timesteps, linear_start, linear_end,
                              device)
    all_sigmas = torch.sqrt((1 - acp) / acp)
    idx = torch.round(torch.linspace(0, num_timesteps - 1, n,
                                     dtype=torch.float64)).long()
    return torch.flip(all_sigmas[idx.to(all_sigmas.device)], (0,))


# --- denoiser scalings: return (c_skip, c_out, c_in, c_noise) -----------

def v_scaling_edm_cnoise(sigma):
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
    c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
    c_noise = 0.25 * torch.log(sigma)
    return c_skip, c_out, c_in, c_noise


def edm_scaling(sigma, sigma_data: float = 0.5):
    c_skip = sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2)
    c_out = sigma * sigma_data / torch.sqrt(sigma ** 2 + sigma_data ** 2)
    c_in = 1.0 / torch.sqrt(sigma ** 2 + sigma_data ** 2)
    c_noise = 0.25 * torch.log(sigma)
    return c_skip, c_out, c_in, c_noise


def eps_scaling(sigma):
    return (torch.ones_like(sigma), -sigma,
            1.0 / torch.sqrt(sigma ** 2 + 1.0), sigma)


SCALINGS = {
    "v_edm_cnoise": v_scaling_edm_cnoise,
    "edm": edm_scaling,
    "eps": eps_scaling,
}


def denoise(net_apply, x, sigma, scaling="v_edm_cnoise"):
    """D(x, sigma) = net(x c_in, c_noise) c_out + x c_skip, ``sigma`` [B]
    broadcast over x's trailing dims."""
    c_skip, c_out, c_in, c_noise = SCALINGS[scaling](sigma)
    shape = (-1,) + (1,) * (x.ndim - 1)
    out = net_apply(x * c_in.reshape(shape), c_noise)
    return out * c_out.reshape(shape) + x * c_skip.reshape(shape)


def raw_net_out(net_apply, x, sigma, scaling="v_edm_cnoise"):
    """The denoiser's ``inv_sample``: the network's raw output
    net(x c_in, c_noise), which the DDIM-style inversion sampler reads."""
    _, _, c_in, c_noise = SCALINGS[scaling](sigma)
    return net_apply(x * c_in.reshape((-1,) + (1,) * (x.ndim - 1)), c_noise)


# --- sigma sampling and loss weighting ----------------------------------

def edm_sigma_sample(shape, p_mean: float = 1.0, p_std: float = 1.6,
                     generator=None, device=None, normal=None):
    """Lognormal sigmas exp(p_mean + p_std n), n a standard normal of
    ``shape`` drawn from ``generator`` unless given as ``normal``."""
    if normal is None:
        normal = torch.randn(shape, generator=generator, device=device)
    return torch.exp(p_mean + p_std * normal)


def edm_weighting(sigma, sigma_data: float = 1.0):
    return (sigma ** 2 + sigma_data ** 2) / (sigma * sigma_data) ** 2


def v_weighting(sigma):
    return edm_weighting(sigma, sigma_data=1.0)


def eps_weighting(sigma):
    return sigma ** -2.0


def unit_weighting(sigma):
    return torch.ones_like(sigma)
