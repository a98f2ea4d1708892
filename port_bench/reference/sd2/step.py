"""One SDS step on the splats, plain PyTorch in float32: the port's
``sds_trainer.sds_train_step`` as ``sds_train.py``'s loop body defines
it. Render the view (``reference/gs``), the background-preserving
(1 - 0.2) L1 + 0.2 (1 - SSIM) on the unmasked region (prediction and
target both multiplied by 1 - mask), clip the render to [0, 1], shrink
it to ``size``^2 by the antialiased bilinear resize (``jax.image.resize``
"bilinear") and the mask by the nearest rule, add ``sds_weight`` times
the prior's SDS loss, differentiate the sum once into the six fields,
then the grouped Adam (eps 1e-15, torch-style bias correction,
non-finite gradient entries zeroed) at the preset's learning rates.
"""

from __future__ import annotations

import torch

from ..gs import model as gs
from ..svd.clip_vit import resize_bilinear
from .prior import resize_nearest

FIELDS = gs.FIELDS


def sds_steps(prior, fields: dict, cams, targets, masks, bg, opt: dict,
              spatial_lr_scale: float, sh_degree: int, text_embs, draws,
              sds_weight: float, size: int) -> dict:
    """One step per (t, noise) of ``draws`` on views 0, 1, ... from
    ``fields``. Returns {"losses": [(sds, total)], "grads": {field: the
    first step's gradient}, "fields": {field: after the last step}}."""
    p = {k: v.detach().clone() for k, v in fields.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": []}
    for i, (t, noise) in enumerate(draws):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        rgb, _ = gs.render(leaves, cams[i], bg, sh_degree)
        keep = (1.0 - masks[i])[..., None]
        bg_loss = gs.loss_of(rgb * keep, targets[i] * keep,
                             opt["lambda_dssim"])
        img = resize_bilinear(rgb.clamp(0.0, 1.0)[None], (size, size))[0]
        sds = prior.sds_loss(img, resize_nearest(masks[i], (size, size)),
                             text_embs, t, noise)
        total = bg_loss + sds_weight * sds
        grads = torch.autograd.grad(total, [leaves[k] for k in FIELDS])
        out["losses"].append((float(sds.detach()), float(total.detach())))
        step = i + 1
        lrs = gs.group_lrs(opt, step, spatial_lr_scale)
        bc1, bc2 = 1.0 - gs.B1 ** step, 1.0 - gs.B2 ** step
        with torch.no_grad():
            for k, g in zip(FIELDS, grads):
                g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                if i == 0:
                    out.setdefault("grads", {})[k] = g.clone()
                mu[k] = gs.B1 * mu[k] + (1 - gs.B1) * g
                nu[k] = gs.B2 * nu[k] + (1 - gs.B2) * g * g
                p[k] = p[k] - lrs[k] * (mu[k] / bc1) / (
                    torch.sqrt(nu[k] / bc2) + gs.EPS)
    out["fields"] = p
    return out
