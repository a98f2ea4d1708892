"""Quaternion helpers, batched.

Port of ``multiview_inpaint_tpu/utils/quaternion.py`` (reference
``gs-simp/utils/general_utils.py:80-112``): unnormalised quaternion
(r, x, y, z) -> rotation matrix; covariance factor L = R @ diag(scale).
Densification resamples split gaussians through the rotation.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[N, 4] unnormalised quaternion (w, x, y, z) -> [N, 3, 3] rotation."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)
    q = q / norm
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return rot.reshape(q.shape[:-1] + (3, 3))


def scaling_rotation(scale: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): [N,3] scale, [N,4] quat -> [N,3,3] factor."""
    return quat_to_rotmat(q) * scale[..., None, :]


def covariance_from_scaling_rotation(scale: torch.Tensor, q: torch.Tensor,
                                     scaling_modifier: float = 1.0
                                     ) -> torch.Tensor:
    """Full 3D covariance Sigma = L L^T, [N, 3, 3]."""
    L = scaling_rotation(scaling_modifier * scale, q)
    return L @ L.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[N,3,3] symmetric -> [N,6] upper-triangular (xx,xy,xz,yy,yz,zz)."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
                       dim=-1)
