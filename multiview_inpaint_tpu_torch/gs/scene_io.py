"""Scene loading: COLMAP / Blender readers -> camera lists + point cloud.

Capability parity with ``gs-simp/scene/dataset_readers.py`` and
``utils/camera_utils.py``: nerf++ normalization (1.1x max camera distance),
llffhold=8 eval split, Blender ``transforms_train.json`` support, and the
resolution-divisor image loading rules (divisors 1/2/4/8; width>1600
auto-downscale when resolution==-1).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, NamedTuple, Optional

import numpy as np

from ..utils import graphics
from . import colmap, ply_io
from .cameras import Camera, make_camera


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    fovy: float
    fovx: float
    image_path: str
    image_name: str
    width: int
    height: int


@dataclasses.dataclass
class SceneInfo:
    points: np.ndarray
    colors: np.ndarray
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_translate: np.ndarray
    nerf_radius: float
    ply_path: str


def nerfpp_norm(cam_infos: List[CameraInfo]):
    centers = []
    for cam in cam_infos:
        w2c = graphics.world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - avg, axis=-1).max()
    return -avg, float(diagonal * 1.1)


def read_colmap_scene(path: str, images_dir: str = "images",
                      eval_split: bool = False,
                      llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    try:
        cams = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        imgs = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    except FileNotFoundError:
        cams = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        imgs = colmap.read_images_text(os.path.join(sparse, "images.txt"))

    infos = []
    for iid in sorted(imgs, key=lambda k: imgs[k].name):
        im = imgs[iid]
        intr = cams[im.camera_id]
        R = colmap.qvec2rotmat(im.qvec).T
        T = im.tvec
        if intr.model == "SIMPLE_PINHOLE":
            fx = fy = intr.params[0]
        elif intr.model == "PINHOLE":
            fx, fy = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"Unsupported COLMAP camera model {intr.model}; undistort "
                f"to PINHOLE/SIMPLE_PINHOLE first")
        infos.append(CameraInfo(
            uid=intr.id, R=R, T=T,
            fovy=graphics.focal2fov(fy, intr.height),
            fovx=graphics.focal2fov(fx, intr.width),
            image_path=os.path.join(path, images_dir,
                                    os.path.basename(im.name)),
            image_name=os.path.splitext(os.path.basename(im.name))[0],
            width=intr.width, height=intr.height))

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        ply_io.store_point_cloud(ply_path, xyz.astype(np.float32), rgb)
    pts, cols, _ = ply_io.fetch_point_cloud(ply_path)

    translate, radius = nerfpp_norm(train)
    return SceneInfo(points=pts, colors=cols, train_cameras=train,
                     test_cameras=test, nerf_translate=translate,
                     nerf_radius=radius, ply_path=ply_path)


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = False) -> SceneInfo:
    """NeRF-synthetic ``transforms_{train,test}.json`` scenes."""

    def read_split(fname):
        with open(os.path.join(path, fname)) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        infos = []
        for i, frame in enumerate(meta["frames"]):
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # blender -> colmap camera convention
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            img_path = os.path.join(path, frame["file_path"] + ".png")
            w, h = _image_size(img_path)
            fovy = graphics.focal2fov(graphics.fov2focal(fovx, w), h)
            infos.append(CameraInfo(
                uid=i, R=R, T=T, fovy=fovy, fovx=fovx, image_path=img_path,
                image_name=os.path.basename(frame["file_path"]),
                width=w, height=h))
        return infos

    train = read_split("transforms_train.json")
    test = (read_split("transforms_test.json")
            if eval_split and os.path.exists(
                os.path.join(path, "transforms_test.json")) else [])
    translate, radius = nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # Random init inside [-1.3, 1.3]^3 like the reference.
        rng = np.random.default_rng(0)
        xyz = (rng.random((100_000, 3)) * 2.6 - 1.3).astype(np.float32)
        ply_io.store_point_cloud(ply_path, xyz,
                                 rng.random((100_000, 3)) * 255)
    pts, cols, _ = ply_io.fetch_point_cloud(ply_path)
    return SceneInfo(points=pts, colors=cols, train_cameras=train,
                     test_cameras=test, nerf_translate=translate,
                     nerf_radius=radius, ply_path=ply_path)


def _image_size(path: str):
    from PIL import Image
    with Image.open(path) as im:
        return im.size


def load_image(path: str, resolution: Optional[tuple] = None,
               grayscale: bool = False) -> np.ndarray:
    """PNG/JPG -> float32 [H, W, C] (or [H, W] grayscale) in [0, 1].

    PNGs decode through the native C++ library when it builds
    (``data.native_io``, ``native/dataio.cpp``); PIL handles resizing and
    other formats.
    """
    from PIL import Image

    from ..data import native_io
    if path.endswith(".png") and native_io.native_available():
        im = Image.fromarray(native_io.decode_png(path))
    else:
        im = Image.open(path)
    with im:
        im = im.convert("L" if grayscale else "RGB")
        if resolution is not None:
            im = im.resize(resolution)
        arr = np.asarray(im, dtype=np.float32) / 255.0
    return arr


def save_image(path: str, arr: np.ndarray) -> None:
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(arr)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def resolve_resolution(width: int, height: int, resolution: int,
                       scale: float = 1.0) -> tuple:
    """``loadCam`` divisor logic (``utils/camera_utils.py:20-53``)."""
    if resolution in (1, 2, 4, 8):
        return (round(width / (scale * resolution)),
                round(height / (scale * resolution)))
    if resolution == -1:
        global_down = width / 1600 if width > 1600 else 1
        s = global_down * scale
        return round(width / s), round(height / s)
    # explicit target width
    global_down = width / resolution
    s = global_down * scale
    return round(width / s), round(height / s)


def camera_from_info(info: CameraInfo, resolution: int = -1,
                     scale: float = 1.0, load_image_data: bool = True
                     ) -> Camera:
    w, h = resolve_resolution(info.width, info.height, resolution, scale)
    img = load_image(info.image_path, (w, h)) if load_image_data else None
    return make_camera(uid=info.uid, R=info.R, T=info.T, fovx=info.fovx,
                       fovy=info.fovy, width=w, height=h,
                       image_name=info.image_name, image=img,
                       colmap_id=info.uid)


def camera_to_json(idx: int, cam: CameraInfo) -> dict:
    w2c = graphics.world_to_view(cam.R, cam.T)
    c2w = np.linalg.inv(w2c)
    pos = c2w[:3, 3]
    rot = c2w[:3, :3]
    return {
        "id": idx, "img_name": cam.image_name, "width": cam.width,
        "height": cam.height, "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fy": graphics.fov2focal(cam.fovy, cam.height),
        "fx": graphics.fov2focal(cam.fovx, cam.width),
    }
