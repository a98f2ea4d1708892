"""EDM math: the Karras sigma ladder, the denoiser scalings, ``denoise``.

Counterpart of ``multiview_inpaint_tpu/diffusion/edm.py`` (the
reference's ``discretizer.py`` EDMDiscretization(0.002, 700, rho 7) and
``denoiser_scaling.py``) for inference: sigma sampling and loss weights
belong to the training slice.
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
