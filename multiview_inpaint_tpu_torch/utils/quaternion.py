"""Quaternion helpers, batched.

Port of ``multiview_inpaint_tpu/utils/quaternion.py`` (reference
``gs-simp/utils/general_utils.py:80-112``): unnormalised quaternion
(r, x, y, z) -> rotation matrix. Densification resamples split gaussians
through it.
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
