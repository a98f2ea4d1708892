"""Data-parallel GS training over a batch of views.

Port of ``multiview_inpaint_tpu/parallel/gs_data_parallel.py``: the
parameters are replicated, each rank renders its slice of the view batch
and forms the L1+SSIM loss of each view, and the gradients of the summed
losses, divided by the global batch size, are summed over the ranks with
one ``all_reduce`` per field, so every rank holds the gradient of the
mean loss over all views (the JAX step's ``jnp.mean``). The same grouped
Adam then runs on every rank. As in the JAX step, this Adam does not zero
non-finite gradient entries and the densification statistics are not
updated.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..gs.gaussians import PARAM_FIELDS, GaussianParams
from ..models.gs_trainer import (OptimizationConfig, TrainState, adam_fields,
                                 leaves, loss_terms)
from ..ops.rasterizer import RenderCamera, render
from ..utils.device import DEFAULT_DEVICE, resolve_device
from . import mesh


class CameraBatch(NamedTuple):
    """Array-of-structs camera batch (leading dim = views)."""
    world_view: torch.Tensor  # [B, 4, 4]
    full_proj: torch.Tensor   # [B, 4, 4]
    campos: torch.Tensor      # [B, 3]
    images: torch.Tensor      # [B, H, W, 3]

    @classmethod
    def from_cameras(cls, cams, device=DEFAULT_DEVICE) -> "CameraBatch":
        dev = resolve_device(device)

        def t(xs):
            return torch.as_tensor(np.stack(xs), dtype=torch.float32,
                                   device=dev)

        return cls(world_view=t([c.world_view for c in cams]),
                   full_proj=t([c.full_proj for c in cams]),
                   campos=t([c.camera_center for c in cams]),
                   images=t([c.image for c in cams]))


def dp_train_step(state: TrainState, batch: CameraBatch, bg_color,
                  cfg: OptimizationConfig, spatial_lr_scale: float,
                  tan_fovx: float, tan_fovy: float, width: int, height: int,
                  sh_degree: int = 0) -> tuple[TrainState, torch.Tensor]:
    """One step over this rank's shard ``batch`` of the view batch (see
    ``shard_for_dp``): returns the new state and the mean loss over all
    views, the same on every rank."""
    p = state.params
    dev = p.xyz.device
    fields, _ = leaves(p)
    params = GaussianParams(live=p.live, **fields)
    n_views = batch.images.shape[0] * mesh.world()
    local = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(batch.images.shape[0]):
        cam = RenderCamera(world_view=batch.world_view[i],
                           full_proj=batch.full_proj[i],
                           campos=batch.campos[i], tan_fovx=tan_fovx,
                           tan_fovy=tan_fovy, width=width, height=height)
        out = render(params, cam, bg_color, sh_degree=sh_degree,
                     device=dev)
        local = local + loss_terms(out.rgb, batch.images[i], cfg)[0]
    grads = torch.autograd.grad(local / n_views,
                                [fields[f] for f in PARAM_FIELDS])
    grads = {f: mesh.all_reduce_sum(g) for f, g in zip(PARAM_FIELDS, grads)}
    loss = mesh.all_reduce_sum(local.detach()) / n_views
    step = state.step + 1
    new_fields, mu, nu, _ = adam_fields(
        {f: getattr(p, f) for f in PARAM_FIELDS}, state.mu, state.nu, grads,
        p.live, step, cfg, spatial_lr_scale, zero_nonfinite=False)
    return dataclasses.replace(
        state, params=GaussianParams(live=p.live, **new_fields), mu=mu,
        nu=nu, step=step), loss


def shard_for_dp(state: TrainState, batch: CameraBatch
                 ) -> tuple[TrainState, CameraBatch]:
    """Rank 0's train state broadcast to every rank (in place), and this
    rank's slice of the view batch."""
    mesh.replicate([state.params, state.mu, state.nu, state.stats])
    return state, mesh.shard_batch(batch)
