"""SDS coarse-geometry step, the reference ``sds_train.py`` loop body.

Counterpart of ``multiview_inpaint_tpu/models/sds_trainer.py``: one step
renders the view, takes the background-preserving L1+SSIM on the
(1 - mask) region (``sds_train.py:116-118``), clips the render to [0, 1]
and shrinks it to ``sds_size``^2 (``jax.image.resize`` bilinear, the
antialiased triangle kernel; the mask by the half-pixel nearest rule),
adds ``sds_weight`` (1e-6) times the SDS loss of the inpainting prior,
and differentiates the sum once into the gaussian fields and the
``means2d_offset`` leaf: through the rasterizer (K3 on CUDA), the resize
and the VAE encoder. Then the grouped Adam of ``gs_trainer`` (eps
1e-15), with the densification statistics.

The Adam update is ``gs_trainer.apply_adam``: the JAX step repeats the
same Adam inline, except that it does not zero and count non-finite
gradient entries; the two agree whenever the gradients are finite.

Spans (``telemetry``): ``sds.step`` around it all; inside it ``render``,
the guidance's ``sds.encode`` (twice) and ``sds.prior``, ``sds.backward``
around ``torch.autograd.grad`` and ``sds.adam`` around ``apply_adam``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import telemetry
from ..diffusion.clip_vit import resize_bilinear
from ..gs.gaussians import PARAM_FIELDS, GaussianParams
from ..guidance.sds import resize_nearest
from ..ops.rasterizer import RenderCamera, render
from .gs_trainer import (OptimizationConfig, TrainState, apply_adam, leaves,
                         loss_terms)


class SDSMetrics(NamedTuple):
    loss: torch.Tensor
    bg_loss: torch.Tensor
    sds_loss: torch.Tensor
    pairs: int = 0
    nonfinite_grads: torch.Tensor = 0


def sds_train_step(state: TrainState, camera: RenderCamera,
                   gt_image: torch.Tensor, mask: torch.Tensor, bg_color,
                   cfg: OptimizationConfig, guidance, text_embs,
                   spatial_lr_scale: float = 1.0, sh_degree: int = 0,
                   sds_weight: float = 1e-6, sds_size: int = 512,
                   generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> tuple[TrainState, SDSMetrics]:
    """One SDS step on the device of ``state``. ``gt_image`` [H, W, 3],
    ``mask`` [H, W] (1 = the object's region); ``guidance`` an
    ``SDSGuidance``; its draws come from ``generator`` unless ``t`` and
    ``noise`` are given."""
    with telemetry.span("sds.step"):
        p = state.params
        fields, offset = leaves(p)
        out = render(GaussianParams(live=p.live, **fields), camera, bg_color,
                     sh_degree=sh_degree, means2d_offset=offset,
                     device=p.xyz.device)
        bg, _ = loss_terms(out.rgb, gt_image, cfg, mask, "background")
        zero = torch.zeros((), device=out.rgb.device)
        clipped = torch.minimum(torch.maximum(out.rgb, zero), zero + 1.0)
        img = resize_bilinear(clipped[None], (sds_size, sds_size))[0]
        mask_s = resize_nearest(mask, (sds_size, sds_size))
        sds = guidance.train_step(img, mask_s, text_embs,
                                  generator=generator, t=t, noise=noise)
        total = bg + sds_weight * sds
        with telemetry.span("sds.backward"):
            *g_fields, g_offset = torch.autograd.grad(
                total, [fields[f] for f in PARAM_FIELDS] + [offset])
        with telemetry.span("sds.adam"):
            new_state, nonfinite = apply_adam(
                state, dict(zip(PARAM_FIELDS, g_fields)), g_offset,
                out.radii, out.visibility, cfg, spatial_lr_scale)
        return new_state, SDSMetrics(loss=total.detach(),
                                     bg_loss=bg.detach(),
                                     sds_loss=sds.detach(), pairs=out.pairs,
                                     nonfinite_grads=nonfinite)
