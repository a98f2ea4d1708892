"""Cross-frame warp maps for the warp-consistency loss.

The port's own copy of ``multiview_inpaint_tpu/data/warp.py`` (numpy
only). Parity with ``SVDForwardLeastDataset3``'s geometry
(``sgm/data/my_dataset.py:1954-2099``): unproject each frame's pixel grid
through its depth map into world space, re-project frame t+1's surface
points into frame t's camera, and emit

- ``uv_ind``  [(T-1), C, h*w] flat gather indices into frame t's latent
  grid for every pixel of frame t+1 (channel-broadcast),
- ``hit_map`` [(T-1), h, w]  1 where the reprojection lands inside the
  image and the depth is valid,

which ``diffusion.losses.warp_consistency_loss`` consumes.
"""

from __future__ import annotations

import numpy as np


def compute_warp_maps(depths: np.ndarray, poses_c2w: np.ndarray,
                      K: np.ndarray, latent_hw, channels: int = 4,
                      depth_valid_min: float = 1e-6):
    """depths [T, H, W] metric; poses_c2w [T, 4, 4]; K [3, 3] at (H, W).

    Returns (hit_map [(T-1), h, w] float32, uv_ind [(T-1), C, h*w] int32)
    at the latent resolution ``latent_hw``.
    """
    t, H, W = depths.shape
    h, w = latent_hw
    # Rescale intrinsics to latent grid and downsample depth (nearest).
    sx, sy = w / W, h / H
    fx, fy = K[0, 0] * sx, K[1, 1] * sy
    cx, cy = K[0, 2] * sx, K[1, 2] * sy
    ys = (np.arange(h) + 0.5) / sy - 0.5
    xs = (np.arange(w) + 0.5) / sx - 0.5
    d = depths[:, np.clip(np.round(ys).astype(int), 0, H - 1)][
        :, :, np.clip(np.round(xs).astype(int), 0, W - 1)]  # [T, h, w]

    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    z = d  # [T, h, w]
    x_cam = (jj[None] - cx) / fx * z
    y_cam = (ii[None] - cy) / fy * z
    ones = np.ones_like(z)
    pts = np.stack([x_cam, y_cam, z, ones], axis=1).reshape(t, 4, -1)
    world = poses_c2w @ pts                        # [T, 4, h*w]

    w2c = np.linalg.inv(poses_c2w)
    prev_cam = w2c[:t - 1] @ world[1:]             # next pts in prev cams
    zc = prev_cam[:, 2]
    u = prev_cam[:, 0] / np.where(np.abs(zc) > 1e-9, zc, 1e-9) * fx + cx
    v = prev_cam[:, 1] / np.where(np.abs(zc) > 1e-9, zc, 1e-9) * fy + cy
    # floor() like the reference (my_dataset.py:2083 ``frames_uv.floor()``)
    ui = np.floor(u).astype(np.int64)
    vi = np.floor(v).astype(np.int64)
    valid = ((d[1:].reshape(t - 1, -1) > depth_valid_min)
             & (zc > depth_valid_min)
             & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h))
    flat = np.clip(vi, 0, h - 1) * w + np.clip(ui, 0, w - 1)
    uv_ind = np.repeat(flat[:, None, :], channels, axis=1).astype(np.int32)
    hit_map = valid.reshape(t - 1, h, w).astype(np.float32)
    return hit_map, uv_ind
