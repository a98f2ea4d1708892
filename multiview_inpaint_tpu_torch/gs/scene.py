"""Scene manager: workspace layout, camera sets, orbit synthesis.

Port of ``multiview_inpaint_tpu/gs/scene.py`` (reference
``gs-simp/scene/__init__.py``): the :class:`Workspace` directory
contract, :class:`Scene` (cameras + the ``add -> del -> iteration_N``
checkpoint cascade) and the stage-1 camera builders, numpy copies of the
JAX functions:

- :func:`orbit_cameras` == ``Scene.getSeqCameras`` (:129-198): a 14-frame
  orbit around the OBB anchored at the scene's front view, modes x1/x2
  (horizontal +-) and y1/y2 (vertical).
- :func:`sds_cameras` == ``getSDSCameras`` (:258-290): training cameras
  within ``cos(view_range)`` of the front direction with box masks.
- :func:`inpaint_cameras` == ``getInpaintCameras`` (:200-255): orbit frames
  composited as ``inpainted * sam_mask + render * (1-mask)``.
- :func:`inpaint_train_cameras` == ``InpaintScene.getInpaintTrainCameras``
  (:415-453): seq + masked train cams, count-balanced by repetition.
- :func:`load_sd_ply` == ``InpaintGaussianModel.load_sd_ply``: the
  background PLY plus fresh gaussians uniform in the insertion box. The
  JAX function draws the box samples from ``jax.random.key(seed)``, which
  torch cannot reproduce: the port draws them from a ``torch.Generator``
  seeded by ``seed``, or takes the uniforms ``u`` as given.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import List, Optional

import numpy as np

import torch

from ..config.registries import FRONT_VIEWS, SPIN_NERF_SCENES
from ..utils.device import DEFAULT_DEVICE, resolve_device
from . import gaussians as g_mod
from . import obb as obb_mod
from . import ply_io, scene_io
from .cameras import Camera, retarget
from .gaussians import GaussianParams
from .obb import OBB


def _normalize(v):
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)


@dataclasses.dataclass(frozen=True)
class Workspace:
    """Directory contract of the pipeline (reference: cwd of gs-simp).

    ``inpaint`` is the hand-off directory shared with the SVD stage; set
    it to an absolute path to point both sides at the same tree.
    """
    root: str = "."
    inpaint: str = "inpaint"

    def _inp(self, *parts) -> str:
        base = (self.inpaint if os.path.isabs(self.inpaint)
                else os.path.join(self.root, self.inpaint))
        return os.path.join(base, *parts)

    def bds_add(self, scene_case: str) -> str:
        return os.path.join(self.root, "bds", "add", f"{scene_case}.obj")

    def bds_del(self, scene: str) -> str:
        return os.path.join(self.root, "bds", "del", f"{scene}.obj")

    def seq_dir(self, scene_case: str, mode: str,
                iteration: int = 30000) -> str:
        return self._inp("seq", scene_case, mode, f"ours_{iteration}")

    def sam_mask_dir(self, scene_case: str, ctrl_id: int, mode: str) -> str:
        return self._inp("sam_mask", scene_case, f"ctrl_{ctrl_id}", mode)

    def inpainted_dir(self, scene_case: str, ctrl_id: int, mode: str) -> str:
        return self._inp("inpainted", scene_case, f"ctrl_{ctrl_id}", mode)

    def depth_dir(self, scene_case: str, mode: str) -> str:
        return self._inp("depth", scene_case, mode)

    def ctrl_dir(self, scene_case: str, curated: bool = False) -> str:
        return self._inp("ctrl1" if curated else "ctrl", scene_case)


class Scene:
    """Loads a reconstructed scene: cameras + gaussian checkpoint cascade.
    Gaussians land on ``device``."""

    def __init__(self, source_path: str, model_path: str,
                 resolution: int = 8, eval_split: bool = False,
                 white_background: bool = False, shuffle: bool = True,
                 load_iteration: Optional[int] = None,
                 max_sh_degree: int = 0, images_dir: str = "images",
                 workspace: Optional[Workspace] = None,
                 load_images: bool = True, capacity: Optional[int] = None,
                 load_gaussians: bool = True, seed: int = 0,
                 device=DEFAULT_DEVICE):
        self.source_path = source_path
        self.model_path = model_path
        self.workspace = workspace or Workspace()
        self.scene_name = os.path.basename(model_path.rstrip("/"))
        self.max_sh_degree = max_sh_degree
        self.resolution = resolution

        # SpinNeRF scenes auto-switch to 1/4 resolution (reference :89-92).
        actual_scene = self.scene_name.split("_")[0]
        if actual_scene in SPIN_NERF_SCENES:
            self.resolution = 4

        if os.path.isdir(os.path.join(source_path, "sparse")):
            info = scene_io.read_colmap_scene(source_path, images_dir,
                                              eval_split)
        elif os.path.exists(os.path.join(source_path,
                                         "transforms_train.json")):
            info = scene_io.read_blender_scene(source_path, white_background,
                                               eval_split)
        else:
            raise ValueError(f"Could not recognize scene type at "
                             f"{source_path}")
        self.info = info
        self.cameras_extent = info.nerf_radius

        os.makedirs(model_path, exist_ok=True)
        with open(os.path.join(model_path, "cameras.json"), "w") as f:
            json.dump([scene_io.camera_to_json(i, c) for i, c in
                       enumerate(info.test_cameras + info.train_cameras)],
                      f)

        train_infos = list(info.train_cameras)
        test_infos = list(info.test_cameras)
        if shuffle:
            rng = random.Random(seed)
            rng.shuffle(train_infos)
            rng.shuffle(test_infos)
        self._train = [scene_io.camera_from_info(c, self.resolution,
                                                 load_image_data=load_images)
                       for c in train_infos]
        self._test = [scene_io.camera_from_info(c, self.resolution,
                                                load_image_data=load_images)
                      for c in test_infos]

        # Gaussian checkpoint cascade: add -> del -> iteration_N (:100-114).
        self.loaded_iteration = None
        self.gaussians: Optional[GaussianParams]
        if not load_gaussians:
            self.gaussians = None
        elif load_iteration is not None:
            pc_dir = os.path.join(model_path, "point_cloud")
            if load_iteration == -1:
                cascade = [os.path.join(pc_dir, "add", "point_cloud.ply"),
                           os.path.join(pc_dir, "del", "point_cloud.ply")]
                found = next((p for p in cascade if os.path.exists(p)), None)
                if found is None:
                    it = _max_iteration(pc_dir)
                    found = os.path.join(pc_dir, f"iteration_{it}",
                                         "point_cloud.ply")
                    self.loaded_iteration = it
                ply_path = found
            else:
                ply_path = os.path.join(pc_dir,
                                        f"iteration_{load_iteration}",
                                        "point_cloud.ply")
                self.loaded_iteration = load_iteration
            self.gaussians = g_mod.load_ply(ply_path, max_sh_degree,
                                            capacity=capacity, device=device)
        else:
            self.gaussians = g_mod.create_from_pcd(
                info.points, info.colors,
                g_mod.GaussianConfig(max_sh_degree=max_sh_degree),
                capacity=capacity, device=device)

    def save(self, params: GaussianParams, iteration: int) -> str:
        path = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
        g_mod.save_ply(params, path)
        return path

    def train_cameras(self) -> List[Camera]:
        return self._train

    def test_cameras(self) -> List[Camera]:
        return self._test

    def front_view(self) -> Camera:
        actual_scene = self.scene_name.split("_")[0]
        name = FRONT_VIEWS.get(actual_scene)
        for v in self._train:
            if v.image_name == name:
                return v
        raise KeyError(f"front view {name!r} for scene {actual_scene!r} "
                       f"not among train cameras")


def _max_iteration(pc_dir: str) -> int:
    its = [int(d.split("_")[-1]) for d in os.listdir(pc_dir)
           if d.startswith("iteration_")]
    if not its:
        raise FileNotFoundError(f"no iteration_* checkpoints in {pc_dir}")
    return max(its)


def orbit_cameras(front_view: Camera, box: OBB, mode: str = "x1",
                  frames: int = 14, view_range: float = np.pi / 3,
                  y_range: float = np.pi / 12, r_scale: float = 1.0,
                  k_lift: float = 0.0, k_bias: float = 0.0,
                  new_size: tuple = (512, 384)) -> List[Camera]:
    """Synthesize the orbital camera sequence around the OBB.

    ``new_size`` is (height, width) like the reference's ``new_size``
    list; frames are resized keeping focal length.
    """
    c2w = front_view.camera_to_world
    front_pose = c2w[:3, 3]
    front_y = _normalize(c2w[:3, 1])
    box_axes = np.concatenate([box.axes, -box.axes], axis=0)
    box_axes = _normalize(box_axes)
    y_axis = box_axes[np.argmax(box_axes @ front_y)]

    center = np.asarray(box.center)
    f2c = center - front_pose
    scaled_r = np.linalg.norm(f2c) * r_scale
    norm_f2c = _normalize(f2c)
    x_axis = _normalize(np.cross(y_axis, norm_f2c))
    z_axis = _normalize(np.cross(x_axis, y_axis))

    views = []
    for v_i in range(frames):
        if mode in ("x1", "x2"):
            angle = view_range * v_i / frames
            if mode == "x1":
                angle = -angle
            angle = angle + k_bias
            pose = (center - z_axis * scaled_r * np.cos(angle)
                    + x_axis * scaled_r * np.sin(angle)
                    - y_axis * scaled_r * np.sin(k_lift))
            z_vec = _normalize(center - pose)
            x_vec = _normalize(np.cross(y_axis, z_vec))
            y_vec = _normalize(np.cross(z_vec, x_vec))
        elif mode in ("y1", "y2"):
            angle = y_range * v_i / frames
            if mode == "y1":
                angle = -angle
            pose = (center - z_axis * scaled_r * np.cos(angle)
                    + y_axis * scaled_r * np.sin(angle)
                    - y_axis * scaled_r * np.sin(k_lift))
            z_vec = _normalize(center - pose)
            y_vec = _normalize(np.cross(z_vec, x_axis))
            x_vec = _normalize(np.cross(y_vec, z_vec))
        else:
            raise ValueError(f"unknown orbit mode {mode!r}")
        new_c2w = np.eye(4, dtype=np.float32)
        new_c2w[:3, 0] = x_vec
        new_c2w[:3, 1] = y_vec
        new_c2w[:3, 2] = z_vec
        new_c2w[:3, 3] = pose
        views.append(retarget(front_view, new_c2w, image_name=f"{v_i:02d}",
                              width=new_size[1], height=new_size[0]))
    return views


def sds_cameras(scene: Scene, box: OBB, view_range: float = np.pi / 3,
                iteration: int = 30000, shuffle: bool = True,
                seed: int = 0) -> List[Camera]:
    """Cone-filtered train cameras with box masks for SDS training."""
    ws = scene.workspace
    train_mask_dir = ws.seq_dir(scene.scene_name, "bds_train", iteration)
    poses = np.load(os.path.join(ws.seq_dir(scene.scene_name, "x1",
                                            iteration), "poses.npy"))
    center = np.asarray(box.center)
    front2center = _normalize(center - poses[0][:3, 3])
    cos_thres = np.cos(view_range)
    out = []
    for cam in scene.train_cameras():
        cam2center = _normalize(center - cam.camera_center)
        if float(cam2center @ front2center) > cos_thres:
            img = scene_io.load_image(
                os.path.join(train_mask_dir, "renders",
                             f"{cam.image_name}.png"))
            mask = scene_io.load_image(
                os.path.join(train_mask_dir, "mask",
                             f"{cam.image_name}.png"), grayscale=True)
            if mask.max() > 0:
                out.append(dataclasses.replace(cam, image=img, mask=mask))
    if shuffle:
        random.Random(seed).shuffle(out)
    return out


def inpaint_cameras(scene: Scene, n_mode: int = 2, ctrl_id: int = -1,
                    frames: int = 14, iteration: int = 30000
                    ) -> List[Camera]:
    """Orbit frames with multi-view-inpainted images composited over the
    original renders through the SAM masks."""
    ws = scene.workspace
    front = scene.front_view()
    mode_list = ["x2", "x1", "y1", "y2"]
    used = mode_list[:n_mode]

    def seq_views(mode):
        seq_root = ws.seq_dir(scene.scene_name, mode, iteration)
        if ctrl_id >= 0:
            mask_root = ws.sam_mask_dir(scene.scene_name, ctrl_id, mode)
            inp_root = ws.inpainted_dir(scene.scene_name, ctrl_id, mode)
        else:
            mask_root = os.path.join(os.path.dirname(
                ws.sam_mask_dir(scene.scene_name, 0, mode)), mode)
            inp_root = os.path.join(os.path.dirname(
                ws.inpainted_dir(scene.scene_name, 0, mode)), mode)
        poses = np.load(os.path.join(seq_root, "poses.npy"))
        views = []
        for i in range(frames):
            v_id = f"{i:02d}"
            if os.path.isdir(inp_root):
                # composite at the inpainted (SVD output) resolution;
                # renders and masks may be at gen_seq's input size
                inp = scene_io.load_image(os.path.join(inp_root,
                                                       f"{v_id}.png"))
                res = (inp.shape[1], inp.shape[0])
                mask = scene_io.load_image(
                    os.path.join(mask_root, f"{v_id}.png"),
                    resolution=res, grayscale=True)
                raw = scene_io.load_image(
                    os.path.join(seq_root, "renders", f"{v_id}.png"),
                    resolution=res)
                img = inp * mask[..., None] + raw * (1 - mask[..., None])
            else:
                mask = scene_io.load_image(os.path.join(mask_root,
                                                        f"{v_id}.png"),
                                           grayscale=True)
                img = scene_io.load_image(os.path.join(
                    seq_root, "renders", f"{v_id}.png"))
            h, w = img.shape[:2]
            views.append(retarget(front, poses[i].astype(np.float32),
                                  image_name=v_id, width=w, height=h,
                                  image=img, mask=mask, inpainted=True))
        return views

    out = seq_views(used[0])
    for m in used[1:]:
        out += seq_views(m)[1:]
    return out


def inpaint_train_cameras(scene: Scene, n_mode: int = 2, ctrl_id: int = -1,
                          frames: int = 14, iteration: int = 30000,
                          shuffle: bool = True, seed: int = 0
                          ) -> List[Camera]:
    """Seq (inpainted) + train (bg-masked) cameras, count-balanced."""
    ws = scene.workspace
    train_mask_dir = ws.seq_dir(scene.scene_name, "bds_train", iteration)
    seq_cams = inpaint_cameras(scene, n_mode, ctrl_id, frames, iteration)
    train_cams = []
    for cam in scene.train_cameras():
        img = scene_io.load_image(os.path.join(
            train_mask_dir, "renders", f"{cam.image_name}.png"))
        mask = scene_io.load_image(os.path.join(
            train_mask_dir, "mask", f"{cam.image_name}.png"), grayscale=True)
        train_cams.append(dataclasses.replace(cam, image=img, mask=mask,
                                              inpainted=False))
    n_train, n_seq = len(train_cams), len(seq_cams)
    if n_seq >= n_train * 2:
        cams = seq_cams + train_cams * (n_seq // n_train)
    elif n_train >= n_seq * 2:
        cams = seq_cams * (n_train // n_seq) + train_cams
    else:
        cams = seq_cams + train_cams
    if shuffle:
        random.Random(seed).shuffle(cams)
    return cams


def load_sd_ply(path: str, box: OBB, n_samples: int = 30_000,
                max_sh_degree: int = 0, capacity: Optional[int] = None,
                seed: int = 0, u: Optional[torch.Tensor] = None,
                device=DEFAULT_DEVICE) -> GaussianParams:
    """Background PLY + n_samples fresh gaussians uniform inside the OBB,
    on ``device``.

    Reference: ``InpaintGaussianModel.load_sd_ply``
    (``gaussian_model.py:493-559``): new gaussians are gray (zero SH),
    opacity 0.1, identity rotation and an isotropic log-scale from the
    mean squared distance to their 3 nearest neighbours among the new
    points (clipped at 1e-7). The box uniforms ``u`` [n_samples, 3] come
    from a ``torch.Generator`` seeded by ``seed`` on ``device`` unless
    given. Capacity is 1.5x the rows unless given.
    """
    from ..ops.knn import knn_mean_sq_dist
    from ..utils.schedules import inverse_sigmoid

    dev = resolve_device(device)
    bg = ply_io.load_gaussian_ply(path, max_sh_degree)
    m = bg["features_rest"].shape[1]
    gen = None
    if u is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    else:
        u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    new_xyz = obb_mod.sample_uniform(box, gen, n_samples, u=u)
    d2 = torch.clamp(knn_mean_sq_dist(new_xyz), min=1e-7)
    new_scales = torch.log(torch.sqrt(d2))[:, None].repeat(1, 3)
    rots = torch.zeros((n_samples, 4), dtype=torch.float32, device=dev)
    rots[:, 0] = 1.0
    opac = torch.full((n_samples, 1),
                      float(inverse_sigmoid(torch.tensor(0.1))),
                      dtype=torch.float32, device=dev)

    def cat(old, new):
        return torch.cat([torch.as_tensor(old, dtype=torch.float32,
                                          device=dev), new])

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    total = len(bg["xyz"]) + n_samples
    return g_mod.from_arrays(
        cat(bg["xyz"], new_xyz),
        cat(bg["features_dc"], zeros(n_samples, 1, 3)),
        cat(bg["features_rest"], zeros(n_samples, m, 3)),
        cat(bg["opacity"], opac),
        cat(bg["scaling"], new_scales),
        cat(bg["rotation"], rots),
        capacity=capacity or int(total * 1.5), device=dev)
