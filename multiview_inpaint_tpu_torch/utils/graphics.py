"""Camera / projection math for the 3DGS pipeline.

Behavioral parity with the reference camera conventions
(``gs-simp/utils/graphics_utils.py:17-76`` in JiuTongBro/MultiView_Inpaint):
row-vector world-to-view matrices, OpenGL-less z_sign=+1 projection with
far-plane normalization, and the fov<->focal helpers used by the COLMAP
loaders. Implemented on numpy (host-side camera setup is not a hot path;
everything device-side consumes the resulting 4x4 matrices as constants).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class BasicPointCloud(NamedTuple):
    points: np.ndarray  # [N, 3] float
    colors: np.ndarray  # [N, 3] float in [0, 1]
    normals: np.ndarray  # [N, 3] float


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera matrix from COLMAP-convention (R, t).

    ``R`` is the camera-to-world rotation (transposed on entry, matching the
    reference's ``getWorld2View2``); ``translate``/``scale`` recentre the
    camera position (used by the nerf++ normalization).
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


# Reference-parity alias.
getWorld2View2 = world_to_view


def projection_matrix(znear: float, zfar: float,
                      fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection with the 3DGS z_sign=+1 convention.

    Matches ``getProjectionMatrix`` in the reference: NDC z maps to
    ``zfar/(zfar-znear) - zfar*znear/((zfar-znear) z)``.
    """
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))
