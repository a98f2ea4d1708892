"""Gaussian-splatting trainer: train step, grouped Adam, densification.

Port of ``multiview_inpaint_tpu/models/gs_trainer.py`` (the reference
training loops ``gs-simp/train.py:31-132``, ``sds_train.py``,
``inpaint_rec.py`` as one reusable trainer):

- One **train step** = render + photometric loss + gradients + grouped
  Adam + densification statistics. The parameters of the step are fresh
  leaf tensors with ``requires_grad``, and ``means2d_offset`` is one more
  leaf whose gradient is the screen-space signal densification reads.
  On CUDA the render's backward runs the composite backward kernel (K3).
- Adam is hand-rolled, exactly the reference's (eps 1e-15, torch-style
  bias correction, dead rows frozen, non-finite gradient entries zeroed
  and counted), over the six parameter fields, so moment surgery after
  densify/prune is a masked zeroing. It is not ``torch.optim.Adam``.
- Per-group LRs mirror ``OptimizationParams``/``InpaintOptimizationParams``
  (``gs-simp/arguments/__init__.py:76-116``), the xyz group on the
  log-lerp schedule scaled by the scene's spatial extent.
- Densify, prune and opacity reset edit the fixed-capacity buffers
  (``gs.densify``); the host loop doubles the capacity when densification
  runs out of free slots.
- Loss masking: plain (train.py) and background-only (sds_train.py).

The JAX step's TPU knobs (``max_per_tile``, ``pair_budget_mult``,
``backend``, ``expand_window``) have no counterpart: the port allocates
its pairs exactly and has one rasterizer per device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import telemetry
from ..gs import densify as densify_mod
from ..gs.densify import DensifyStats
from ..gs.gaussians import PARAM_FIELDS, GaussianParams
from ..ops.rasterizer import RenderCamera, render
from ..utils import losses as loss_utils
from ..utils.schedules import expon_lr

_B1, _B2, _EPS = 0.9, 0.999, 1e-15


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """Mirrors the reference OptimizationParams defaults."""
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    max_screen_size: int = 20  # applied after opacity_reset_interval


# The stage-2 / SDS preset (reference InpaintOptimizationParams).
INPAINT_OPT = OptimizationConfig(
    iterations=5_000, position_lr_init=0.001, position_lr_final=0.00002,
    position_lr_delay_mult=0.02, position_lr_max_steps=300,
    feature_lr=0.01, rotation_lr=0.005, densification_interval=50,
    opacity_reset_interval=700, densify_from_iter=0,
    densify_until_iter=3_000)


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    mu: dict            # Adam first moments, per field
    nu: dict            # Adam second moments, per field
    stats: DensifyStats
    step: int


def init_state(params: GaussianParams) -> TrainState:
    def zeros():
        return {f: torch.zeros_like(getattr(params, f)) for f in PARAM_FIELDS}

    return TrainState(params=params, mu=zeros(), nu=zeros(),
                      stats=DensifyStats.zeros(params.capacity,
                                               params.xyz.device),
                      step=0)


def _group_lrs(cfg: OptimizationConfig, step, spatial_lr_scale: float):
    xyz_lr = expon_lr(step, cfg.position_lr_init * spatial_lr_scale,
                      cfg.position_lr_final * spatial_lr_scale,
                      cfg.position_lr_max_steps,
                      lr_delay_mult=cfg.position_lr_delay_mult,
                      lr_delay_steps=0)
    return {"xyz": xyz_lr,
            "features_dc": cfg.feature_lr,
            "features_rest": cfg.feature_lr / 20.0,
            "opacity": cfg.opacity_lr,
            "scaling": cfg.scaling_lr,
            "rotation": cfg.rotation_lr}


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    num_live: torch.Tensor
    pairs: int = 0  # gaussian-tile pairs of the rendered view
    # Count of non-finite gradient entries this step (zeroed before the
    # Adam update so one degenerate backward cannot poison the moments);
    # a persistent non-zero count flags a diverging run.
    nonfinite_grads: torch.Tensor = 0


def leaves(params: GaussianParams) -> tuple[dict, torch.Tensor]:
    """Fresh leaf tensors with ``requires_grad`` for the six fields, and
    the zero ``means2d_offset`` leaf."""
    fields = {f: getattr(params, f).detach().requires_grad_(True)
              for f in PARAM_FIELDS}
    offset = torch.zeros((params.capacity, 2), dtype=torch.float32,
                         device=params.xyz.device, requires_grad=True)
    return fields, offset


def loss_terms(rgb: torch.Tensor, gt_image: torch.Tensor,
               cfg: OptimizationConfig, mask: Optional[torch.Tensor] = None,
               loss_mode: str = "full"):
    """(loss, l1) of a rendered [H, W, 3] image against ``gt_image``."""
    pred, gt = rgb, gt_image
    if loss_mode == "background":
        keep = (1.0 - mask)[..., None]
        pred = pred * keep
        gt = gt * keep
    elif loss_mode != "full":
        raise ValueError(f"unknown loss_mode {loss_mode!r}")
    pred_c = pred.permute(2, 0, 1)   # losses take [C, H, W]
    gt_c = gt.permute(2, 0, 1)
    l1 = loss_utils.l1_loss(pred_c, gt_c)
    loss = ((1.0 - cfg.lambda_dssim) * l1
            + cfg.lambda_dssim * (1.0 - loss_utils.ssim(pred_c, gt_c)))
    return loss, l1


@torch.no_grad()
def adam_fields(fields: dict, mu: dict, nu: dict, grads: dict,
                live: torch.Tensor, step: int, cfg: OptimizationConfig,
                spatial_lr_scale: float, zero_nonfinite: bool = True):
    """The grouped Adam update of ``step`` (the new step number) on the
    six fields' rows (all of them, or one rank's slice with its ``live``
    rows): returns (new fields, new mu, new nu, non-finite count). Dead
    rows get no update; with ``zero_nonfinite`` non-finite gradient
    entries are zeroed and counted (the data-parallel step, as the JAX
    one, keeps them)."""
    n = live.shape[0]
    lrs = _group_lrs(cfg, step, spatial_lr_scale)
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = 1.0 - torch.tensor(_B1, dtype=torch.float32) ** t
    bc2 = 1.0 - torch.tensor(_B2, dtype=torch.float32) ** t
    zero = torch.zeros((), dtype=torch.float32, device=live.device)
    nonfinite = torch.zeros((), dtype=torch.int64, device=live.device)
    new_fields, new_mu, new_nu = {}, {}, {}
    for f in PARAM_FIELDS:
        g = grads[f]
        rowmask = live.reshape((n,) + (1,) * (g.dim() - 1))
        g = torch.where(rowmask, g, zero)      # no updates for dead rows
        if zero_nonfinite:
            # Zero and count non-finite entries: one degenerate backward
            # (near-singular conic, saturated alpha) would otherwise write
            # inf/NaN into the moments, which is absorbing.
            g_ok = torch.isfinite(g)
            nonfinite = nonfinite + (~g_ok).sum()
            g = torch.where(g_ok, g, zero)
        m = _B1 * mu[f] + (1 - _B1) * g
        v = _B2 * nu[f] + (1 - _B2) * g * g
        upd = lrs[f] * (m / bc1) / (torch.sqrt(v / bc2) + _EPS)
        new_fields[f] = fields[f] - torch.where(rowmask, upd, zero)
        new_mu[f] = m
        new_nu[f] = v
    return new_fields, new_mu, new_nu, nonfinite


@torch.no_grad()
def update_stats(stats: DensifyStats, g_offset: torch.Tensor,
                 radii: torch.Tensor, visibility: torch.Tensor
                 ) -> tuple[DensifyStats, torch.Tensor]:
    """The densification statistics from the ``means2d_offset`` gradient
    (non-finite entries zeroed) and the render's radii and visibility;
    returns them and the count of non-finite entries."""
    off_ok = torch.isfinite(g_offset)
    zero = torch.zeros((), dtype=g_offset.dtype, device=g_offset.device)
    return (stats.update(torch.where(off_ok, g_offset, zero), radii,
                         visibility), (~off_ok).sum())


@torch.no_grad()
def apply_adam(state: TrainState, grads: dict, g_offset: torch.Tensor,
               radii: torch.Tensor, visibility: torch.Tensor,
               cfg: OptimizationConfig, spatial_lr_scale: float
               ) -> tuple[TrainState, torch.Tensor]:
    """Grouped Adam on the six fields and the densification statistics
    (``g_offset``, the ``means2d_offset`` gradient, with the render's
    ``radii`` and ``visibility``); returns the new state and the count of
    non-finite gradient entries."""
    with telemetry.span("trainer.adam"):
        p = state.params
        step = state.step + 1
        fields = {f: getattr(p, f) for f in PARAM_FIELDS}
        new_fields, new_mu, new_nu, nonfinite = adam_fields(
            fields, state.mu, state.nu, grads, p.live, step, cfg,
            spatial_lr_scale)
        stats, off_bad = update_stats(state.stats, g_offset, radii,
                                      visibility)
        return TrainState(params=GaussianParams(live=p.live, **new_fields),
                          mu=new_mu, nu=new_nu, stats=stats,
                          step=step), nonfinite + off_bad


def train_step(state: TrainState, camera: RenderCamera,
               gt_image: torch.Tensor, bg_color, cfg: OptimizationConfig,
               spatial_lr_scale: float, sh_degree: int = 0,
               mask: Optional[torch.Tensor] = None, loss_mode: str = "full"
               ) -> tuple[TrainState, StepMetrics]:
    """One optimization iteration, on the device of ``state``.

    ``gt_image`` [H, W, 3]; ``mask`` [H, W] optional. ``loss_mode``:
      - "full": photometric on the whole frame;
      - "background": both pred and gt multiplied by (1 - mask)
        (SDS background preservation).

    Spans (``telemetry``): ``trainer.step`` around it all, inside it
    ``render``, ``trainer.loss``, ``trainer.backward`` and
    ``trainer.adam``.
    """
    with telemetry.span("trainer.step"):
        p = state.params
        fields, offset = leaves(p)
        out = render(GaussianParams(live=p.live, **fields), camera,
                     bg_color, sh_degree=sh_degree, means2d_offset=offset,
                     device=p.xyz.device)
        with telemetry.span("trainer.loss"):
            loss, l1 = loss_terms(out.rgb, gt_image, cfg, mask, loss_mode)
        with telemetry.span("trainer.backward"):
            *g_fields, g_offset = torch.autograd.grad(
                loss, [fields[f] for f in PARAM_FIELDS] + [offset])
        new_state, nonfinite = apply_adam(state,
                                          dict(zip(PARAM_FIELDS, g_fields)),
                                          g_offset, out.radii,
                                          out.visibility, cfg,
                                          spatial_lr_scale)
        return new_state, StepMetrics(loss=loss.detach(), l1=l1.detach(),
                                      num_live=p.live.sum(),
                                      pairs=out.pairs,
                                      nonfinite_grads=nonfinite)


def zero_moments(state: TrainState, row_mask: torch.Tensor,
                 fields=PARAM_FIELDS) -> TrainState:
    """Masked Adam-moment reset (the reference's optimizer surgery)."""
    mu = dict(state.mu)
    nu = dict(state.nu)
    for f in fields:
        m = row_mask.reshape((-1,) + (1,) * (mu[f].dim() - 1))
        mu[f] = torch.where(m, torch.zeros_like(mu[f]), mu[f])
        nu[f] = torch.where(m, torch.zeros_like(nu[f]), nu[f])
    return dataclasses.replace(state, mu=mu, nu=nu)


def maybe_densify(state: TrainState, generator: Optional[torch.Generator],
                  cfg: OptimizationConfig, extent: float,
                  iteration: int) -> tuple[TrainState, dict]:
    """Host-called densification for one iteration.

    Mirrors the schedule of ``train.py:112-124``: densify+prune every
    ``densification_interval`` in [from, until); screen-size pruning only
    after the first opacity reset; opacity reset every
    ``opacity_reset_interval``. The split resamples draw from
    ``generator``.
    """
    info = {}
    if iteration < cfg.densify_until_iter:
        if (iteration >= cfg.densify_from_iter
                and iteration % cfg.densification_interval == 0):
            max_screen = (cfg.max_screen_size
                          if iteration > cfg.opacity_reset_interval else None)
            res = densify_mod.densify_and_prune(
                state.params, state.stats, cfg.densify_grad_threshold, 0.005,
                extent, max_screen, cfg.percent_dense, generator=generator)
            state = dataclasses.replace(state, params=res.params,
                                        stats=res.stats)
            state = zero_moments(state, res.moment_reset)
            info = {"cloned": res.n_cloned, "split": res.n_split,
                    "pruned": res.n_pruned, "wanted": res.wanted_slots,
                    "granted": res.granted_slots}
        if iteration % cfg.opacity_reset_interval == 0 and iteration > 0:
            params, op_mask = densify_mod.reset_opacity(state.params)
            state = dataclasses.replace(state, params=params)
            state = zero_moments(state, op_mask, fields=("opacity",))
            info["opacity_reset"] = True
    return state, info


def grow_if_needed(state: TrainState, info: dict) -> TrainState:
    """Double capacity when densification ran out of free slots."""
    if info and info.get("granted", 0) < info.get("wanted", 0):
        new_cap = state.params.capacity * 2
        params, stats = densify_mod.grow_capacity(state.params, state.stats,
                                                  new_cap)

        def pad_moments(d):
            return {f: densify_mod.pad_rows(d[f], new_cap)
                    for f in PARAM_FIELDS}

        return TrainState(params=params, mu=pad_moments(state.mu),
                          nu=pad_moments(state.nu), stats=stats,
                          step=state.step)
    return state
