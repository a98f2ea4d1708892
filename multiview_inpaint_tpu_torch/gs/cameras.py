"""Camera model: an immutable dataclass with derived transforms.

Capability parity with the reference ``Camera``/``MiniCam``
(``gs-simp/scene/cameras.py:18-114``) as a functional value type: no mutable
``update_attr`` — ``retarget`` returns a new camera with a new pose (and
optionally new resolution, keeping the focal length, exactly the semantics
of ``update_attr(change_size=True)``).

Convention note: we store standard **column-vector** matrices
(``world_view @ [x;1]``); the reference stores their transposes for
row-vector multiplication. ``full_proj = proj @ world_view``. znear=0.01,
zfar=100 as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..utils import graphics

ZNEAR = 0.01
ZFAR = 100.0


@dataclasses.dataclass(frozen=True)
class Camera:
    uid: int
    image_name: str
    width: int
    height: int
    fovx: float
    fovy: float
    world_view: np.ndarray  # [4,4] world->camera (column-vector)
    # Optional payloads (H, W, C) float32 in [0,1]:
    image: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None
    inpainted: bool = False
    colmap_id: int = -1

    @property
    def projection(self) -> np.ndarray:
        return graphics.projection_matrix(ZNEAR, ZFAR, self.fovx, self.fovy)

    @property
    def full_proj(self) -> np.ndarray:
        return self.projection @ self.world_view

    @property
    def camera_to_world(self) -> np.ndarray:
        return np.linalg.inv(self.world_view)

    @property
    def camera_center(self) -> np.ndarray:
        return self.camera_to_world[:3, 3]

    @property
    def tan_half_fovx(self) -> float:
        return float(np.tan(self.fovx / 2))

    @property
    def tan_half_fovy(self) -> float:
        return float(np.tan(self.fovy / 2))


def make_camera(uid: int, R: np.ndarray, T: np.ndarray, fovx: float,
                fovy: float, width: int, height: int, image_name: str = "",
                image: Optional[np.ndarray] = None,
                mask: Optional[np.ndarray] = None,
                trans: Optional[np.ndarray] = None, scale: float = 1.0,
                colmap_id: int = -1, inpainted: bool = False) -> Camera:
    """From COLMAP-convention (R, T) like the reference Camera ctor."""
    w2v = graphics.world_to_view(R, T, translate=trans, scale=scale)
    return Camera(uid=uid, image_name=image_name, width=width, height=height,
                  fovx=fovx, fovy=fovy, world_view=w2v, image=image,
                  mask=mask, colmap_id=colmap_id, inpainted=inpainted)


def retarget(cam: Camera, camera_to_world: np.ndarray,
             image_name: str = "", width: Optional[int] = None,
             height: Optional[int] = None,
             image: Optional[np.ndarray] = None,
             mask: Optional[np.ndarray] = None,
             inpainted: bool = True) -> Camera:
    """New pose (+ optional new resolution keeping focal length).

    Mirrors ``Camera.update_attr``: when resizing, the FoV is recomputed so
    the focal length in pixels is preserved.
    """
    fovx, fovy = cam.fovx, cam.fovy
    w, h = cam.width, cam.height
    if width is not None and height is not None:
        focal_x = graphics.fov2focal(cam.fovx, cam.width)
        focal_y = graphics.fov2focal(cam.fovy, cam.height)
        fovx = graphics.focal2fov(focal_x, width)
        fovy = graphics.focal2fov(focal_y, height)
        w, h = width, height
    return Camera(uid=cam.uid, image_name=image_name or cam.image_name,
                  width=w, height=h, fovx=fovx, fovy=fovy,
                  world_view=np.linalg.inv(camera_to_world).astype(np.float32),
                  image=image, mask=mask, colmap_id=cam.colmap_id,
                  inpainted=inpainted)


def get_rays(cam: Camera) -> tuple[np.ndarray, np.ndarray]:
    """Pinhole ray origins/directions [H*W, 3] in world space.

    Same pixel-center convention as the reference ``helpers.get_rays``
    (``gs-simp/scene/helpers.py:107-140``).
    """
    c2w = cam.camera_to_world
    fx = graphics.fov2focal(cam.fovx, cam.width)
    fy = graphics.fov2focal(cam.fovy, cam.height)
    # cx = W//2 (integer, matching the reference), pixel centers at +0.5.
    xs = (np.arange(cam.width, dtype=np.float32) + 0.5 - cam.width // 2) / fx
    ys = (np.arange(cam.height, dtype=np.float32) + 0.5 - cam.height // 2) / fy
    xv, yv = np.meshgrid(xs, ys)
    dirs_cam = np.stack([xv, yv, np.ones_like(xv)], axis=-1)  # [H,W,3]
    dirs = dirs_cam @ c2w[:3, :3].T
    origins = np.broadcast_to(c2w[:3, 3], dirs.shape)
    return (origins.reshape(-1, 3).astype(np.float32),
            dirs.reshape(-1, 3).astype(np.float32))
