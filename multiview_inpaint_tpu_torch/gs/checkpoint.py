"""Full trainer-state checkpointing (params, Adam moments, stats, step).

Port of ``multiview_inpaint_tpu/gs/checkpoint.py`` (the reference's
``torch.save((gaussians.capture(), iter))``, ``gs-simp/train.py:130-132``)
as a compressed npz with the JAX file's keys, so a JAX ``chkpnt*.npz``
loads into the port and the port's loads into JAX. The PLY stays the
inter-stage contract; this is for resume.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.gs_trainer import TrainState
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .densify import DensifyStats
from .gaussians import PARAM_FIELDS, GaussianParams


def save_train_state(path: str, state: TrainState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def arr(t):
        return t.detach().cpu().numpy()

    arrs = {}
    for f in PARAM_FIELDS:
        arrs[f"param_{f}"] = arr(getattr(state.params, f))
        arrs[f"mu_{f}"] = arr(state.mu[f])
        arrs[f"nu_{f}"] = arr(state.nu[f])
    arrs["live"] = arr(state.params.live)
    arrs["grad_accum"] = arr(state.stats.grad_accum)
    arrs["denom"] = arr(state.stats.denom)
    arrs["max_radii2d"] = arr(state.stats.max_radii2d)
    arrs["step"] = np.asarray(state.step, np.int32)
    np.savez_compressed(path, **arrs)


def load_train_state(path: str, device=DEFAULT_DEVICE) -> TrainState:
    dev = resolve_device(device)
    with np.load(path) as z:
        def t(key):
            return torch.from_numpy(np.array(z[key])).to(dev)

        params = GaussianParams(live=t("live"),
                                **{f: t(f"param_{f}") for f in PARAM_FIELDS})
        return TrainState(
            params=params,
            mu={f: t(f"mu_{f}") for f in PARAM_FIELDS},
            nu={f: t(f"nu_{f}") for f in PARAM_FIELDS},
            stats=DensifyStats(grad_accum=t("grad_accum"), denom=t("denom"),
                               max_radii2d=t("max_radii2d")),
            step=int(z["step"]))
