"""Classifier-free-guidance guiders as prepare/combine pairs.

Counterpart of ``multiview_inpaint_tpu/diffusion/guiders.py`` (the
reference's ``guiders.py``): IdentityGuider, VanillaCFG, the
LinearPredictionGuider of SVD, whose CFG scale rises linearly over the
frames, with ``additional_cond_keys`` (``control_hint``) doubled into the
uc|c batch as well, the no-op LinearPredictionGuider2 of the inversion
path (one batch, c only) and the TrianglePredictionGuider, whose scale
follows triangle waves over the frames. The per-frame scales are f32.
Conditioning is a flat dict of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

_BUILTIN_KEYS = ("vector", "crossattn", "concat")


def _cat_conds(c: Dict, uc: Dict, keys) -> Dict:
    return {k: (torch.cat([uc[k], c[k]], dim=0) if k in keys else c[k])
            for k in c}


@dataclasses.dataclass(frozen=True)
class IdentityGuider:
    def prepare(self, x, s, c, uc):
        return x, s, dict(c)

    def combine(self, out, sigma):
        return out


@dataclasses.dataclass(frozen=True)
class VanillaCFG:
    scale: float = 1.0
    additional_cond_keys: Tuple[str, ...] = ()

    def prepare(self, x, s, c, uc):
        keys = _BUILTIN_KEYS + tuple(self.additional_cond_keys)
        return (torch.cat([x, x]), torch.cat([s, s]),
                _cat_conds(c, uc, keys))

    def combine(self, out, sigma):
        x_u, x_c = out.chunk(2, dim=0)
        return x_u + self.scale * (x_c - x_u)


@dataclasses.dataclass(frozen=True)
class LinearPredictionGuider:
    max_scale: float = 2.5
    num_frames: int = 14
    min_scale: float = 1.0
    additional_cond_keys: Tuple[str, ...] = ("control_hint",)

    def frame_scales(self, device=None) -> torch.Tensor:
        return torch.linspace(self.min_scale, self.max_scale,
                              self.num_frames, dtype=torch.float32,
                              device=device)

    def prepare(self, x, s, c, uc):
        keys = _BUILTIN_KEYS + tuple(self.additional_cond_keys)
        return (torch.cat([x, x]), torch.cat([s, s]),
                _cat_conds(c, uc, keys))

    def combine(self, out, sigma):
        x_u, x_c = out.chunk(2, dim=0)
        t = self.num_frames
        b = x_u.shape[0] // t
        scale = self.frame_scales(out.device).repeat(b).reshape(
            (b, t) + (1,) * (x_u.ndim - 1))
        x_u = x_u.reshape((b, t) + x_u.shape[1:])
        x_c = x_c.reshape((b, t) + x_c.shape[1:])
        mixed = x_u + scale * (x_c - x_u)
        return mixed.reshape((b * t,) + mixed.shape[2:])


@dataclasses.dataclass(frozen=True)
class LinearPredictionGuider2(LinearPredictionGuider):
    """No-op guider of the DDIM-inversion path (one batch, c only)."""

    def prepare(self, x, s, c, uc):
        return x, s, dict(c)

    prepare_inv = prepare

    def combine(self, out, sigma):
        return out


@dataclasses.dataclass(frozen=True)
class TrianglePredictionGuider(LinearPredictionGuider):
    """Per-frame scale from triangle waves of the given periods over the
    frames (t in [0, 1]), fused by ``max``, ``mean`` or ``multiply``."""
    period: Tuple[float, ...] = (1.0,)
    period_fusing: str = "max"

    def frame_scales(self, device=None) -> torch.Tensor:
        values = torch.linspace(0, 1, self.num_frames, dtype=torch.float32,
                                device=device)

        def tri(p):
            return 2 * torch.abs(values / p - torch.floor(values / p + 0.5))

        scales = torch.stack([tri(p) for p in self.period])
        if self.period_fusing == "mean":
            s = scales.mean(0)
        elif self.period_fusing == "multiply":
            s = scales.prod(0)
        else:
            s = scales.amax(0)
        return s * (self.max_scale - self.min_scale) + self.min_scale
