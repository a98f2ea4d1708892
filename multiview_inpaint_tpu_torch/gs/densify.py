"""Adaptive density control on fixed-capacity buffers.

Port of ``multiview_inpaint_tpu/gs/densify.py`` (reference
``gs-simp/scene/gaussian_model.py:426-484`` and the optimizer surgery at
:335-404). The layout is the reference's, row for row:

- The buffer keeps its capacity. Pruned rows flip ``live`` off; clones
  and the second sample of each split are written into dead slots, taken
  in index order (a stable sort on "not free").
- A split replaces its row in place by one resample and writes the second
  resample into a free slot.
- Optimizer surgery is a masked zeroing of the Adam moments of every
  written row (``moment_reset``).
- Capacity pressure is returned (``wanted`` vs ``granted``) so the
  trainer can double the buffers.

JAX writes rows with ``.at[dest].set(..., mode="drop")`` and drops the
out-of-range ``dest`` of rows that got no slot; here only the granted rows
are selected and written. The split resamples draw from an explicit
``torch.Generator`` unless the caller passes the normal draws (``noise``).

Screen-space gradient statistics live in :class:`DensifyStats`, which the
trainer accumulates from the ``means2d_offset`` gradient and the radii.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..utils.quaternion import quat_to_rotmat
from ..utils.schedules import inverse_sigmoid
from .gaussians import FIELDS, PARAM_FIELDS, GaussianParams


@dataclasses.dataclass
class DensifyStats:
    grad_accum: torch.Tensor   # [C] sum of screen-space grad norms
    denom: torch.Tensor        # [C] number of visible accumulations
    max_radii2d: torch.Tensor  # [C] int32 max screen radius seen

    @classmethod
    def zeros(cls, capacity: int, device) -> "DensifyStats":
        return cls(
            grad_accum=torch.zeros(capacity, dtype=torch.float32,
                                   device=device),
            denom=torch.zeros(capacity, dtype=torch.float32, device=device),
            max_radii2d=torch.zeros(capacity, dtype=torch.int32,
                                    device=device))

    def update(self, means2d_grad: torch.Tensor, radii: torch.Tensor,
               visibility: torch.Tensor) -> "DensifyStats":
        """Per-iteration accumulation (``add_densification_stats``)."""
        norm = torch.linalg.vector_norm(means2d_grad[:, :2], dim=-1)
        zero = torch.zeros((), dtype=norm.dtype, device=norm.device)
        return DensifyStats(
            grad_accum=self.grad_accum + torch.where(visibility, norm, zero),
            denom=self.denom + visibility.to(torch.float32),
            max_radii2d=torch.maximum(
                self.max_radii2d,
                torch.where(visibility, radii, torch.zeros_like(radii))))


class DensifyResult(NamedTuple):
    params: GaussianParams
    moment_reset: torch.Tensor  # [C] bool: rows whose Adam moments to zero
    stats: DensifyStats         # reset to zeros
    n_cloned: int
    n_split: int
    n_pruned: int
    wanted_slots: int           # free slots asked for
    granted_slots: int          # free slots there were


def _scatter_rows(params: GaussianParams, dest: torch.Tensor,
                  src: GaussianParams, rows: torch.Tensor,
                  field_overrides: dict) -> GaussianParams:
    """Write ``src`` rows ``rows`` (or their overrides) into slots
    ``dest`` of ``params``, live."""
    out = {}
    for f in PARAM_FIELDS:
        val = field_overrides.get(f, getattr(src, f))[rows]
        t = getattr(params, f).clone()
        t[dest] = val
        out[f] = t
    live = params.live.clone()
    live[dest] = True
    return GaussianParams(live=live, **out)


def densify_and_prune(params: GaussianParams, stats: DensifyStats,
                      grad_threshold: float, min_opacity: float,
                      extent: float, max_screen_size: Optional[int],
                      percent_dense: float = 0.01,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[tuple] = None) -> DensifyResult:
    """Clone small hot gaussians, split large hot ones, prune the faint,
    the non-finite and (with ``max_screen_size``) the oversized.

    ``noise``: the two [C, 3] standard-normal draws of the split
    resamples; drawn from ``generator`` when not given.
    """
    cap = params.capacity
    dev = params.xyz.device
    live = params.live
    act_scale = params.act_scaling()
    max_scale = torch.amax(act_scale, dim=-1)

    # Quarantine rows whose params went non-finite: they render nothing
    # (the projector culls them) and must never be cloned or split. They
    # are pruned so the slot recycles.
    row_finite = (torch.isfinite(params.xyz).all(dim=-1)
                  & torch.isfinite(params.scaling).all(dim=-1)
                  & torch.isfinite(params.opacity[:, 0])
                  & torch.isfinite(params.rotation).all(dim=-1)
                  & torch.isfinite(stats.grad_accum))

    grads = stats.grad_accum / torch.clamp(stats.denom, min=1.0)
    hot = live & row_finite & (grads >= grad_threshold)
    clone_mask = hot & (max_scale <= percent_dense * extent)
    split_mask = hot & (max_scale > percent_dense * extent)

    # --- prune ----------------------------------------------------------
    prune = live & (~row_finite | (params.act_opacity()[:, 0] < min_opacity))
    if max_screen_size is not None:
        prune = prune | (live & (stats.max_radii2d > max_screen_size))
        prune = prune | (live & (max_scale > 0.1 * extent))
    prune = prune & ~split_mask  # split rows are rewritten in place anyway
    live_after = live & ~prune

    # --- allocate free slots (in index order) ---------------------------
    free = ~live_after
    slot_by_rank = torch.sort((~free).to(torch.int8), stable=True).indices
    n_free = free.sum()

    clone_rank = torch.cumsum(clone_mask.to(torch.int64), 0) - 1
    n_clone_wanted = clone_mask.sum()
    split_rank = torch.cumsum(split_mask.to(torch.int64), 0) - 1
    wanted = n_clone_wanted + split_mask.sum()

    clone_ok = clone_mask & (clone_rank < n_free)
    split2_ok = split_mask & ((n_clone_wanted + split_rank) < n_free)
    clone_rows = torch.nonzero(clone_ok).flatten()
    split_rows = torch.nonzero(split2_ok).flatten()
    clone_dest = slot_by_rank[clone_rank[clone_rows]]
    split2_dest = slot_by_rank[n_clone_wanted + split_rank[split_rows]]

    # --- split resamples (2 per split row) ------------------------------
    if noise is None:
        noise = tuple(torch.randn((cap, 3), generator=generator,
                                  device=dev) for _ in range(2))
    rot = quat_to_rotmat(params.act_rotation())           # [C, 3, 3]

    def resample(eps):
        eps = eps.to(device=dev, dtype=torch.float32) * act_scale
        return params.xyz + torch.einsum("nij,nj->ni", rot, eps)

    new_xyz1 = resample(noise[0])
    new_xyz2 = resample(noise[1])
    new_scaling = torch.log(torch.clamp(act_scale / (0.8 * 2), min=1e-12))

    p = params
    split_col = split_mask[:, None]
    split_inplace = GaussianParams(
        xyz=torch.where(split_col, new_xyz1, p.xyz),
        features_dc=p.features_dc, features_rest=p.features_rest,
        opacity=torch.where(prune[:, None],
                            torch.full_like(p.opacity, -15.0), p.opacity),
        scaling=torch.where(split_col, new_scaling, p.scaling),
        rotation=p.rotation, live=live_after)

    # clone copies into free slots, then split sample 2 into free slots
    after_clone = _scatter_rows(split_inplace, clone_dest, params,
                                clone_rows, {})
    after_split = _scatter_rows(after_clone, split2_dest, params,
                                split_rows,
                                {"xyz": new_xyz2, "scaling": new_scaling})

    # Rows whose Adam moments are zeroed: every written row.
    moment_reset = split_mask | prune
    moment_reset[clone_dest] = True
    moment_reset[split2_dest] = True

    n_cloned, n_split, n_pruned, wanted, n_free = torch.stack([
        clone_ok.sum(), split_mask.sum(), prune.sum(), wanted,
        n_free]).tolist()
    return DensifyResult(
        params=after_split, moment_reset=moment_reset,
        stats=DensifyStats.zeros(cap, dev), n_cloned=n_cloned,
        n_split=n_split, n_pruned=n_pruned, wanted_slots=wanted,
        granted_slots=min(wanted, n_free))


def reset_opacity(params: GaussianParams) -> tuple[GaussianParams,
                                                   torch.Tensor]:
    """Clamp live opacities to <= 0.01 (reference ``reset_opacity``).

    Returns new params and the moment-reset mask (opacity moments zeroed).
    """
    target = inverse_sigmoid(torch.tensor(0.01, dtype=torch.float32,
                                          device=params.opacity.device))
    new_op = torch.minimum(params.opacity, target)
    new_op = torch.where(params.live[:, None], new_op, params.opacity)
    return dataclasses.replace(params, opacity=new_op), params.live


def pad_rows(t: torch.Tensor, capacity: int, fill=0) -> torch.Tensor:
    pad = torch.full((capacity - t.shape[0],) + tuple(t.shape[1:]), fill,
                     dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


def grow_capacity(params: GaussianParams, stats: DensifyStats,
                  new_capacity: int) -> tuple[GaussianParams, DensifyStats]:
    """Pad the buffers with dead rows (the reference's fill values)."""
    fills = {"opacity": -15.0, "scaling": -15.0, "live": False}
    p = GaussianParams(**{f: pad_rows(getattr(params, f), new_capacity,
                                       fills.get(f, 0.0))
                          for f in FIELDS})
    s = DensifyStats(**{f.name: pad_rows(getattr(stats, f.name),
                                          new_capacity)
                        for f in dataclasses.fields(DensifyStats)})
    return p, s
