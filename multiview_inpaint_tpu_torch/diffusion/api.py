"""High-level sampling API: the reference's ``sgm/inference/api.py``.

Counterpart of ``multiview_inpaint_tpu/diffusion/api.py``: pick a sampler
by name (``Sampler``), configure the discretization and the guider by
``SamplingParams``, and sample in one call over any ``denoise_fn(x,
sigma_vec, cond)``.

The initial noise is a standard normal of ``shape`` drawn from
``generator``, or given as ``noise``; a stochastic sampler's per-step
draws come from the same generator, or are given as ``churn=``,
``renoise=`` or ``ancestral=`` (see ``samplers``). As in the JAX API,
``EULER_EDM_INVERSION`` passes ``inv_guider=IdentityGuider()``, which
both of its passes guide with, so through this API the inversion
resamples unguided, on c only.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional

import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device
from . import edm, samplers
from .guiders import (IdentityGuider, LinearPredictionGuider,
                      TrianglePredictionGuider, VanillaCFG)


class Sampler(str, enum.Enum):
    EULER_EDM = "EulerEDMSampler"
    HEUN_EDM = "HeunEDMSampler"
    EULER_ANCESTRAL = "EulerAncestralSampler"
    DPMPP2M = "DPMPP2MSampler"
    DPMPP2S_ANCESTRAL = "DPMPP2SAncestralSampler"
    LINEAR_MULTISTEP = "LinearMultistepSampler"
    EULER_EDM_BLENDED = "EulerEDMSampler2"
    EULER_EDM_INVERSION = "EulerEDMSampler3"


class Discretization(str, enum.Enum):
    EDM = "EDMDiscretization"
    LEGACY_DDPM = "LegacyDDPMDiscretization"


class Guider(str, enum.Enum):
    IDENTITY = "IdentityGuider"
    VANILLA = "VanillaCFG"
    LINEAR_PREDICTION = "LinearPredictionGuider"
    TRIANGLE_PREDICTION = "TrianglePredictionGuider"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    sampler: Sampler = Sampler.EULER_EDM
    discretization: Discretization = Discretization.EDM
    guider: Guider = Guider.LINEAR_PREDICTION
    steps: int = 25
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0
    scale: float = 2.5          # cfg max scale
    min_scale: float = 1.0
    num_frames: int = 14
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0


def build_sigmas(p: SamplingParams, device=None) -> torch.Tensor:
    """The ladder [steps + 1] in f32, descending, ending in 0."""
    if p.discretization == Discretization.LEGACY_DDPM:
        s = edm.legacy_ddpm_sigmas(p.steps, device=device)
    else:
        s = edm.edm_sigmas(p.steps, p.sigma_min, p.sigma_max, p.rho,
                           device=device)
    return torch.cat([s, s.new_zeros(1)])


def build_guider(p: SamplingParams,
                 additional_cond_keys=("control_hint",)):
    if p.guider == Guider.IDENTITY:
        return IdentityGuider()
    if p.guider == Guider.VANILLA:
        return VanillaCFG(scale=p.scale,
                          additional_cond_keys=tuple(additional_cond_keys))
    if p.guider == Guider.TRIANGLE_PREDICTION:
        return TrianglePredictionGuider(
            max_scale=p.scale, min_scale=p.min_scale,
            num_frames=p.num_frames,
            additional_cond_keys=tuple(additional_cond_keys))
    return LinearPredictionGuider(
        max_scale=p.scale, min_scale=p.min_scale, num_frames=p.num_frames,
        additional_cond_keys=tuple(additional_cond_keys))


class SamplingPipeline:
    """One-call sampling over any ``denoise_fn(x, sigma_vec, cond)``."""

    def __init__(self, denoise_fn, params: SamplingParams = SamplingParams(),
                 inv_denoise_fn=None):
        self.denoise_fn = denoise_fn
        self.inv_denoise_fn = inv_denoise_fn
        self.params = params
        self.guider = build_guider(params)
        self.sigmas = build_sigmas(params)

    def sample(self, shape, cond: Dict, uc: Optional[Dict] = None,
               z: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               device=DEFAULT_DEVICE, **draws) -> torch.Tensor:
        """Sample latents of ``shape`` on ``device`` (the card by default;
        raises without one); ``draws`` go to the sampler (``churn``,
        ``renoise``, ``ancestral``)."""
        p = self.params
        dev = resolve_device(device)
        x = (noise.to(dev, torch.float32) if noise is not None else
             torch.randn(shape, generator=generator, device=dev))
        sigmas = self.sigmas.to(dev)
        dn = self.denoise_fn
        kw = dict(guider=self.guider, generator=generator, s_churn=p.s_churn,
                  s_tmin=p.s_tmin, s_tmax=p.s_tmax, s_noise=p.s_noise)
        if p.sampler == Sampler.HEUN_EDM:
            return samplers.heun_edm_sample(dn, x, cond, uc, sigmas, **kw,
                                            **draws)
        if p.sampler == Sampler.EULER_ANCESTRAL:
            return samplers.euler_ancestral_sample(
                dn, x, cond, uc, sigmas, guider=self.guider,
                generator=generator, s_noise=p.s_noise, **draws)
        if p.sampler == Sampler.DPMPP2M:
            return samplers.dpmpp2m_sample(dn, x, cond, uc, sigmas,
                                           guider=self.guider)
        if p.sampler == Sampler.DPMPP2S_ANCESTRAL:
            return samplers.dpmpp2s_ancestral_sample(
                dn, x, cond, uc, sigmas, guider=self.guider,
                generator=generator, s_noise=p.s_noise, **draws)
        if p.sampler == Sampler.LINEAR_MULTISTEP:
            return samplers.lms_sample(dn, x, cond, uc, sigmas,
                                       guider=self.guider)
        if p.sampler == Sampler.EULER_EDM_BLENDED:
            if z is None or mask is None:
                raise ValueError("the blended sampler needs z and mask")
            return samplers.euler_edm_sample_blended(
                dn, x, cond, uc, sigmas, z, mask, **kw, **draws)
        if p.sampler == Sampler.EULER_EDM_INVERSION:
            if z is None or mask is None or self.inv_denoise_fn is None:
                raise ValueError("the inversion sampler needs z, mask and "
                                 "inv_denoise_fn")
            return samplers.euler_edm_sample_inversion(
                dn, self.inv_denoise_fn, x, cond, uc, sigmas, z, mask,
                guider=self.guider, inv_guider=IdentityGuider(),
                generator=generator, **draws)
        return samplers.euler_edm_sample(dn, x, cond, uc, sigmas, **kw,
                                         **draws)
