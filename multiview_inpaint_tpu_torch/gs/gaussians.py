"""Gaussian scene parameters as fixed-capacity tensors with a ``live`` mask.

Port of ``multiview_inpaint_tpu/gs/gaussians.py`` (reference
``gs-simp/scene/gaussian_model.py:26-147,191-309``). The layout is kept
row for row: parameters live in fixed-capacity buffers, dead rows are
masked by ``live`` and padded with the reference's fill values, so row i
here is row i of the JAX ``GaussianParams`` and states compare row by row.
Activations (sigmoid opacity, clamped exp scale, normalised quaternion)
are plain functions applied where consumed.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..ops.knn import knn_mean_sq_dist
from ..utils import sh as sh_utils
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.schedules import inverse_sigmoid
from . import ply_io

FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation", "live")
PARAM_FIELDS = FIELDS[:-1]  # the optimised float fields (all but live)


@dataclasses.dataclass(frozen=True)
class GaussianConfig:
    max_sh_degree: int = 0  # reference default for this pipeline
    capacity: int = 0  # 0 = size to the initial point count


@dataclasses.dataclass
class GaussianParams:
    """Scene state. All leading dims == capacity (padded)."""
    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, M, 3], M = (deg+1)^2 - 1
    opacity: torch.Tensor        # [C, 1] raw logit
    scaling: torch.Tensor        # [C, 3] log-scale
    rotation: torch.Tensor       # [C, 4] unnormalised quaternion
    live: torch.Tensor           # [C] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def max_sh_degree(self) -> int:
        return int(round((self.features_rest.shape[1] + 1) ** 0.5)) - 1

    def num_live(self) -> torch.Tensor:
        return self.live.sum()

    def features(self) -> torch.Tensor:
        """[C, (deg+1)^2, 3] full SH stack."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def to(self, device) -> "GaussianParams":
        return GaussianParams(**{f: getattr(self, f).to(device)
                                 for f in FIELDS})

    # --- activations -----------------------------------------------------
    def act_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def act_scaling(self) -> torch.Tensor:
        # Clamped exp (as in the reference since its non-finite fix): an
        # unbounded log-scale can drift past f32 overflow under long Adam
        # schedules; the clamp saturates far above any physical scale.
        # ``minimum`` (not ``clamp``) keeps JAX's gradient: a NaN log-scale
        # gets a NaN gradient, which the train step zeroes and counts.
        # The bound is filled on the device: a host value copied to the
        # card would make the host wait for the queue to drain.
        bound = self.scaling.new_full((), 20.0)
        return torch.exp(torch.minimum(self.scaling, bound))

    def act_rotation(self) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(self.rotation * self.rotation, dim=-1,
                                    keepdim=True))
        return self.rotation / norm.clamp(min=1e-12)


def _pad_to(arr: torch.Tensor, capacity: int,
            fill: float = 0.0) -> torch.Tensor:
    pad = torch.full((capacity - arr.shape[0],) + tuple(arr.shape[1:]),
                     fill, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


def from_arrays(xyz, features_dc, features_rest, opacity, scaling, rotation,
                capacity: Optional[int] = None,
                device=DEFAULT_DEVICE) -> GaussianParams:
    """Params from live rows (numpy arrays or tensors), padded to
    ``capacity`` with the reference's dead-row fills."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    n = int(xyz.shape[0])
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} rows")
    rotation = _pad_to(t(rotation), capacity)
    if capacity > n:
        rotation[n:, 0] = 1.0
    return GaussianParams(
        xyz=_pad_to(t(xyz), capacity),
        features_dc=_pad_to(t(features_dc), capacity),
        features_rest=_pad_to(t(features_rest), capacity),
        # Dead rows keep a very negative opacity logit so any code path
        # that forgets the live mask still composites them at ~zero alpha.
        opacity=_pad_to(t(opacity), capacity, -15.0),
        scaling=_pad_to(t(scaling), capacity, -15.0),
        rotation=rotation,
        live=torch.arange(capacity, device=dev) < n,
    )


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      device) -> GaussianParams:
    """Carry weights across from the JAX package: ``arrays`` maps each
    JAX ``GaussianParams`` field (``xyz, features_dc, features_rest,
    opacity, scaling, rotation, live``) to a numpy array, padding rows
    included, and row i stays row i."""
    dev = resolve_device(device)
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"params_from_numpy: missing fields {missing}")
    kw = {f: torch.tensor(np.asarray(arrays[f], np.float32), device=dev)
          for f in FIELDS if f != "live"}
    kw["live"] = torch.tensor(np.asarray(arrays["live"], bool), device=dev)
    return GaussianParams(**kw)


def create_from_pcd(points: np.ndarray, colors: np.ndarray,
                    config: GaussianConfig, capacity: Optional[int] = None,
                    device=DEFAULT_DEVICE) -> GaussianParams:
    """Initialise from a COLMAP point cloud, with the reference recipe
    (``gaussian_model.py:124-147``): DC = RGB2SH(color), isotropic
    log-scale from sqrt(mean 3-NN squared distance), identity
    quaternion, opacity = logit(0.1)."""
    dev = resolve_device(device)
    n = points.shape[0]
    m = (config.max_sh_degree + 1) ** 2 - 1
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    dc = sh_utils.rgb_to_sh(torch.as_tensor(np.asarray(colors, np.float32),
                                            device=dev)).reshape(n, 1, 3)
    rest = torch.zeros((n, m, 3), dtype=torch.float32, device=dev)
    d2 = torch.clamp(knn_mean_sq_dist(pts), min=1e-7)
    scales = torch.log(torch.sqrt(d2))[:, None].repeat(1, 3)
    rots = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rots[:, 0] = 1.0
    opac = inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=torch.float32,
                                            device=dev))
    return from_arrays(pts, dc, rest, opac, scales, rots,
                       capacity=capacity or config.capacity or n,
                       device=dev)


# --- PLY checkpointing (inter-stage contract) ----------------------------

def save_ply(params: GaussianParams, path: str) -> None:
    """Write only live rows, byte-compatible with the reference format."""
    idx = torch.nonzero(params.live).flatten()

    def rows(t):
        return t.detach()[idx].cpu().numpy()

    ply_io.save_gaussian_ply(
        path, rows(params.xyz), rows(params.features_dc),
        rows(params.features_rest), rows(params.opacity),
        rows(params.scaling), rows(params.rotation))


def load_ply(path: str, max_sh_degree: int, capacity: Optional[int] = None,
             device=DEFAULT_DEVICE) -> GaussianParams:
    d = ply_io.load_gaussian_ply(path, max_sh_degree)
    return from_arrays(d["xyz"], d["features_dc"], d["features_rest"],
                       d["opacity"], d["scaling"], d["rotation"],
                       capacity=capacity, device=device)
