"""Scene manager: workspace layout and the gaussian checkpoint cascade.

Port of the render-path part of ``multiview_inpaint_tpu/gs/scene.py``
(reference ``gs-simp/scene/__init__.py``): the :class:`Workspace`
directory contract, :class:`Scene` (cameras + the ``add -> del ->
iteration_N`` checkpoint cascade) and ``_max_iteration``. The orbit, SDS
and inpaint camera builders need the OBB module and come with stage 1's
tools.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import List, Optional

from ..config.registries import FRONT_VIEWS, SPIN_NERF_SCENES
from ..utils.device import DEFAULT_DEVICE
from . import gaussians as g_mod
from . import scene_io
from .cameras import Camera
from .gaussians import GaussianParams


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
