"""Band-sharded GS training: one frame's forward and backward over ranks.

Port of ``multiview_inpaint_tpu/parallel/gs_band_train.py`` (``_build``,
``gs_band_train.py:137-280``). Rank r renders the interleaved band of
tile rows ``r, r + D, ...`` of the frame (``render(band_rows=,
band_row0=, band_stride=D)``) with the ``means2d_offset`` leaf. The
detached bands of every rank are gathered, this rank's differentiable
band is put back in its slot, and the stitched full frame drives the same
L1+SSIM loss as ``gs_trainer.train_step`` (the SSIM windows that cross
band borders see the whole frame). Autograd does not flow through the
collective: each rank's gradient is its own band's pairs' share, and one
``all_reduce(SUM)`` per field (and of the offset gradient) gives the full
frame's gradients. Otherwise the grads would count D times (the JAX
comment at ``gs_band_train.py:158-169``). The grouped Adam, the
non-finite count and the densification statistics are then
``gs_trainer``'s, on every rank.

``zero_sharded=True`` is the ZeRO scheme (``gs_band_train.py:198-229``):
the gradients are reduce-scattered over the capacity rows, rank r owns
rows ``[r N/D, (r+1) N/D)``, Adam and the statistics run on those rows
only, and the updated parameter rows are all-gathered back. The returned
state then holds the rank's rows of ``mu``, ``nu`` and ``stats`` (left
sharded, as in JAX); ``gather_zero_state`` brings them to full rows for a
checkpoint or a comparison. The step takes either layout of them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..gs.densify import DensifyStats
from ..gs.gaussians import PARAM_FIELDS, GaussianParams
from ..models.gs_trainer import (OptimizationConfig, StepMetrics,
                                 TrainState, adam_fields, apply_adam,
                                 leaves, loss_terms, update_stats)
from ..ops.rasterizer import RenderCamera, render
from . import mesh
from .render_parallel import band_layout, stitch_bands

_STATS = ("grad_accum", "denom", "max_radii2d")


def _rows(x: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    return x if x.shape[0] == n else x[r0:r0 + n]


def _reduce_scatter_rows(g: torch.Tensor, n_loc: int) -> torch.Tensor:
    """This rank's [n_loc, ...] rows of the sum of ``g`` over the ranks."""
    if not dist.is_initialized():
        return g
    out = torch.empty((n_loc,) + tuple(g.shape[1:]), dtype=g.dtype,
                      device=g.device)
    dist.reduce_scatter_tensor(out, g.contiguous(), op=dist.ReduceOp.SUM)
    return out


class BandGrads(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    grads: dict               # field -> this band's share of d loss
    g_offset: torch.Tensor    # this band's share of d loss / d means2d
    radii: torch.Tensor       # the full projection's
    visibility: torch.Tensor
    pairs: int                # this band's pairs


def band_grads(params: GaussianParams, camera: RenderCamera,
               gt_image: torch.Tensor, bg_color, cfg: OptimizationConfig,
               n_bands: int, band: int, gather, sh_degree: int = 0
               ) -> BandGrads:
    """Band ``band`` of ``n_bands`` interleaved bands: its render, the
    full-frame loss over the frame stitched from ``gather(rgb)`` ([D,
    band_rows * 16, W, 3], every band's detached rgb given this one's
    [1, ...]) with this band's differentiable rgb in its slot, and this
    band's share of the gradients. ``gather`` is the all-gather of the
    distributed step, or any callable that returns the bands (a single
    process can render them one after another)."""
    tile_h = 16
    band_rows, stride, row0s = band_layout(-(-camera.height // tile_h),
                                           n_bands, True)
    fields, offset = leaves(params)
    out = render(GaussianParams(live=params.live, **fields), camera,
                 bg_color, sh_degree=sh_degree, means2d_offset=offset,
                 band_rows=band_rows, band_row0=row0s[band],
                 band_stride=stride, device=params.xyz.device)
    gathered = gather(out.rgb.detach()[None])
    bands = torch.cat([gathered[:band], out.rgb[None],
                       gathered[band + 1:]])
    full = stitch_bands(bands, True, tile_h, camera.height)
    loss, l1 = loss_terms(full, gt_image, cfg)
    *g_fields, g_offset = torch.autograd.grad(
        loss, [fields[f] for f in PARAM_FIELDS] + [offset])
    return BandGrads(loss.detach(), l1.detach(),
                     dict(zip(PARAM_FIELDS, g_fields)), g_offset, out.radii,
                     out.visibility, out.pairs)


def band_train_step(state: TrainState, camera: RenderCamera,
                    gt_image: torch.Tensor, bg_color,
                    cfg: OptimizationConfig, spatial_lr_scale: float,
                    sh_degree: int = 0, zero_sharded: bool = False
                    ) -> tuple[TrainState, StepMetrics]:
    """One full-frame iteration (``train_step``, loss_mode "full"),
    band-sharded over the ranks; at world size 1 it is ``train_step``.
    ``metrics.pairs`` is the frame's pair count (the bands' sum). The
    JAX ``cull_n`` and pair budgets have no counterpart: the port's
    binning is exact."""
    p = state.params
    dev = p.xyz.device
    n = p.capacity
    n_dev, r = mesh.world(), mesh.rank()
    if zero_sharded and n % n_dev:
        raise ValueError(f"zero_sharded needs capacity {n} divisible by "
                         f"{n_dev}")
    out = band_grads(p, camera, gt_image, bg_color, cfg, n_dev, r,
                     mesh.all_gather_rows, sh_degree)
    grads, g_offset = out.grads, out.g_offset
    pairs = int(mesh.all_reduce_sum(torch.tensor(
        [out.pairs], dtype=torch.int64, device=dev)).item())

    if not zero_sharded:
        grads = {f: mesh.all_reduce_sum(g) for f, g in grads.items()}
        new_state, nonfinite = apply_adam(
            state, grads, mesh.all_reduce_sum(g_offset), out.radii,
            out.visibility, cfg, spatial_lr_scale)
    else:
        n_loc = n // n_dev
        r0 = r * n_loc
        with torch.no_grad():
            live = p.live[r0:r0 + n_loc]
            step = state.step + 1
            loc, mu, nu, nonfinite = adam_fields(
                {f: getattr(p, f)[r0:r0 + n_loc] for f in PARAM_FIELDS},
                {f: _rows(v, r0, n_loc) for f, v in state.mu.items()},
                {f: _rows(v, r0, n_loc) for f, v in state.nu.items()},
                {f: _reduce_scatter_rows(g, n_loc) for f, g in grads.items()},
                live, step, cfg, spatial_lr_scale)
            stats, off_bad = update_stats(
                DensifyStats(**{k: _rows(getattr(state.stats, k), r0, n_loc)
                                for k in _STATS}),
                _reduce_scatter_rows(g_offset, n_loc),
                out.radii[r0:r0 + n_loc], out.visibility[r0:r0 + n_loc])
            nonfinite = mesh.all_reduce_sum(nonfinite + off_bad)
            new_fields = {f: mesh.all_gather_rows(v) for f, v in loc.items()}
        new_state = TrainState(params=GaussianParams(live=p.live,
                                                     **new_fields),
                               mu=mu, nu=nu, stats=stats, step=step)
    return new_state, StepMetrics(loss=out.loss, l1=out.l1,
                                  num_live=p.live.sum(), pairs=pairs,
                                  nonfinite_grads=nonfinite)


def gather_zero_state(state: TrainState) -> TrainState:
    """A ZeRO step's state with ``mu``, ``nu`` and ``stats`` gathered to
    full capacity rows on every rank (a no-op where they are full)."""
    n = state.params.capacity

    def full(x):
        return x if x.shape[0] == n else mesh.all_gather_rows(x)

    return dataclasses.replace(
        state, mu={f: full(v) for f, v in state.mu.items()},
        nu={f: full(v) for f, v in state.nu.items()},
        stats=DensifyStats(**{k: full(getattr(state.stats, k))
                              for k in _STATS}))
