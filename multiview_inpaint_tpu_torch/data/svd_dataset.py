"""The SVD multi-view inpainting datasets (host-side numpy, NHWC).

The port's own copy of what ``svd_test`` and ``svd_train`` need from
``multiview_inpaint_tpu/data/svd_dataset.py`` (a numpy-only module):

- :class:`GSVideoForwardDataset` (the reference's
  GS_VideoForwardDatasetSimp), the inference dataset: for every curated
  control image ``<root>/ctrl1/<scene>/<ctrl>.png`` and orbit mode, the 14
  orbit renders, estimated depths and box masks with the 7-channel
  ``control_hint = [depth(3) | mask(1) | frames*(1-mask)(3)]``;
- :class:`EstSVDForwardDataset` (EstSVDForwardDatasetSimp), the training
  dataset over ``%09d/{rgb,est_depth,masks}`` scenes with random sequence
  reversal, mask shrink and pose conditioning (``compute_poses``,
  ``compute_poses2``);
- :class:`WarpSVDForwardDataset` (SVDForwardLeastDataset3), the
  warp-consistency training dataset (uint16 depth PNGs, ``poses.npy``, a
  column-major K), with the warp maps of ``data.warp``;
- ``epoch_iterator``, ``_load``, ``HINT_MODES``, ``_video_batch`` and
  ``process_mask``.

The random draws use the same ``random.Random`` and
``np.random.default_rng`` seeds as the JAX package's, so both packages
draw the same augmentations.

Conventions: RGB frames in [-1, 1]; depth and masks in [0, 1];
fps_id/motion_bucket/cond_aug per video; images resized to (H, W) =
``size``. Batches are plain dicts of numpy arrays.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Tuple

import numpy as np

from ..gs import scene_io


def _load(path, size: Tuple[int, int], scale=True, grayscale=False):
    """size = (H, W); returns [H, W, C] (or [H, W, 1] grayscale)."""
    h, w = size
    img = scene_io.load_image(path, resolution=(w, h), grayscale=grayscale)
    if grayscale:
        img = img[..., None]
    if scale:
        img = img * 2.0 - 1.0
    return img.astype(np.float32)


HINT_MODES = {
    # channel compositions of the reference's dataset family
    "full": 7,        # depth(3) | mask(1) | frames*(1-mask)(3)
    "nodepth": 4,     # mask(1) | frames*(1-mask)(3)
    "frames_only": 3,  # frames*(1-mask)(3)
    "extended": 8,    # depth(3) | mask(1) | frames*(1-mask)(3) | (1-mask)
    "extended_unmasked": 8,  # depth(3) | mask(1) | frames(3) | (1-mask)
    "no_frames": 4,   # depth(3) | mask(1)
    "nomask": 6,      # depth(3) | frames*(1-mask)(3)
}


def process_mask(mask: np.ndarray, k_max: float = 0.4,
                 rng: random.Random | None = None) -> np.ndarray | None:
    """Random mask-shrink augmentation: shave a random fraction in [0,
    k_max) of the mask's bounding box off each side and return the shrunk
    box as a filled rectangle; None for an empty mask."""
    if mask.ndim == 3:
        mask = np.max(mask, axis=-1)
    h, w = mask.shape
    row_ids = np.argwhere(np.max(mask, axis=1) > 0.0)
    col_ids = np.argwhere(np.max(mask, axis=0) > 0.0)
    if len(row_ids) == 0 or len(col_ids) == 0:
        return None
    row_st, row_ed = int(row_ids[0, 0]), int(row_ids[-1, 0]) + 1
    col_st, col_ed = int(col_ids[0, 0]), int(col_ids[-1, 0]) + 1
    d_h, d_w = row_ed - row_st, col_ed - col_st
    r = rng if rng is not None else random
    k1, k2, k3, k4 = (r.random() * k_max for _ in range(4))
    row_st = max(0, int(row_st + int(d_h * k1)))
    row_ed = min(h, int(row_ed - int(d_h * k2)))
    col_st = max(0, int(col_st + int(d_w * k3)))
    col_ed = min(w, int(col_ed - int(d_w * k4)))
    new_mask = np.zeros_like(mask)
    new_mask[row_st:row_ed, col_st:col_ed] = 1.0
    return new_mask


def compute_poses(poses: np.ndarray, cam_center: np.ndarray | None = None):
    """Orbit pose conditioning (reference ``compute_poses``,
    ``my_dataset.py:19-55``): per-frame (azimuth, polar, scaled_radius)
    relative to the first camera on the orbit sphere. Feeds the
    ``azimuths_rad``/``polars_rad``/``rad`` vector-cond keys (SV3D-style
    conditioning, ``configs/inference/sv3d_p.yaml:84-90``)."""
    cam_poses = poses[:, :3, -1]
    if cam_center is None:
        cam_center = np.mean(cam_poses, axis=0, keepdims=True)
    cam_dirs = cam_poses - cam_center
    radius = np.linalg.norm(cam_dirs, axis=-1)
    scaled_radius = (radius - radius[0]) / radius[0]
    cam_dirs = cam_dirs / radius[:, None]
    c2w_r = poses[:, :3, :3]
    c2w_r = c2w_r / np.linalg.norm(c2w_r, axis=-1, keepdims=True)

    sphere_z = -cam_dirs[0]
    sphere_y = np.cross(sphere_z, c2w_r[0, :, 0])
    sphere_x = np.cross(sphere_y, sphere_z)
    polar_error = np.arccos(np.sum(sphere_z * c2w_r[0, :, 2], axis=-1))
    if sphere_z[1] > c2w_r[0, 1, 2]:
        polar_error = -polar_error
    sphere_c2w = np.stack([sphere_x, sphere_y, sphere_z], axis=1)
    sphere_dirs = (sphere_c2w.T[None] @ cam_dirs.T).T[..., 0]
    sphere_dirs = sphere_dirs / np.linalg.norm(sphere_dirs, axis=-1,
                                               keepdims=True)

    azimuths = np.arctan2(sphere_dirs[:, 0], sphere_dirs[:, 2])
    azimuths = azimuths - azimuths[0]
    azimuths = np.where(azimuths > np.pi, azimuths - 2 * np.pi, azimuths)
    azimuths = np.where(azimuths < -np.pi, azimuths + 2 * np.pi, azimuths)
    azimuths = np.where(azimuths < -np.pi, azimuths + 2 * np.pi, azimuths)
    polars = np.arctan(sphere_dirs[:, 1] / np.sqrt(
        sphere_dirs[:, 0] ** 2 + sphere_dirs[:, 2] ** 2))
    polars = polars + polar_error
    return azimuths, polars, scaled_radius


def compute_poses2(poses: np.ndarray,
                   cam_center: np.ndarray | None = None):
    """``compute_poses`` with SV3D's wrapped ranges: azimuth in [0, 2pi),
    polar in [0, pi) measured from the pole (``my_dataset.py:58-95``)."""
    azimuths, polars, scaled_radius = compute_poses(poses, cam_center)
    # compute_poses returns polars + polar_error; the 2-variant uses
    # (polars + pi/2) - polar_error. Recover the raw polar first.
    # (Re-derive instead of subtracting to avoid sign-flip surprises.)
    cam_poses = poses[:, :3, -1]
    if cam_center is None:
        cam_center = np.mean(cam_poses, axis=0, keepdims=True)
    cam_dirs = cam_poses - cam_center
    cam_dirs = cam_dirs / np.linalg.norm(cam_dirs, axis=-1,
                                         keepdims=True)
    c2w_r = poses[:, :3, :3]
    c2w_r = c2w_r / np.linalg.norm(c2w_r, axis=-1, keepdims=True)
    sphere_z = -cam_dirs[0]
    sphere_y = np.cross(sphere_z, c2w_r[0, :, 0])
    sphere_x = np.cross(sphere_y, sphere_z)
    polar_error = np.arccos(np.sum(sphere_z * c2w_r[0, :, 2], axis=-1))
    if sphere_z[1] > c2w_r[0, 1, 2]:
        polar_error = -polar_error
    sphere_c2w = np.stack([sphere_x, sphere_y, sphere_z], axis=1)
    sphere_dirs = (sphere_c2w.T[None] @ cam_dirs.T).T[..., 0]
    sphere_dirs = sphere_dirs / np.linalg.norm(sphere_dirs, axis=-1,
                                               keepdims=True)
    raw_polars = np.arctan(sphere_dirs[:, 1] / np.sqrt(
        sphere_dirs[:, 0] ** 2 + sphere_dirs[:, 2] ** 2))
    polars2 = (raw_polars + np.pi / 2) - polar_error
    return azimuths % (2 * np.pi), polars2 % np.pi, scaled_radius


def _video_batch(frames, controls, masks, cond_frame, fps_id,
                 motion_bucket_id, cond_aug, rng=None,
                 hint_mode: str = "full", hint_frames=None) -> Dict:
    frames = np.stack(frames)         # [T, H, W, 3] in [-1, 1]
    controls = np.stack(controls)     # [T, H, W, 3] in [0, 1]
    masks = np.stack(masks)           # [T, H, W, 1] in [0, 1]
    bg = 1.0 - masks
    hf = np.stack(hint_frames) if hint_frames is not None else frames
    if hint_mode == "nodepth":
        hint = np.concatenate([masks, hf * bg], axis=-1)
    elif hint_mode == "frames_only":
        hint = hf * bg
    elif hint_mode == "extended":
        hint = np.concatenate([controls, masks, hf * bg, bg], axis=-1)
    elif hint_mode == "extended_unmasked":
        hint = np.concatenate([controls, masks, hf, bg], axis=-1)
    elif hint_mode == "no_frames":
        hint = np.concatenate([controls, masks], axis=-1)
    elif hint_mode == "nomask":
        hint = np.concatenate([controls, hf * bg], axis=-1)
    else:
        hint = np.concatenate([controls, masks, hf * bg], axis=-1)
    t = frames.shape[0]
    noise = (rng.standard_normal(cond_frame.shape).astype(np.float32)
             if rng is not None else 0.0)
    return {
        "jpg": frames,
        "control_hint": hint,
        "masks": masks,
        "cond_frames_without_noise": cond_frame[None],
        "cond_frames": (cond_frame + cond_aug * noise)[None],
        "fps_id": np.full((1,), fps_id, np.float32),
        "motion_bucket_id": np.full((1,), motion_bucket_id, np.float32),
        "cond_aug": np.full((1,), cond_aug, np.float32),
        "image_only_indicator": np.zeros((1, t), np.float32),
        "num_video_frames": t,
    }


class GSVideoForwardDataset:
    """Inference dataset over the gs/ directory contract: ``ctrl1/<scene>/
    <ctrl>.png``, ``seq/<scene>/<mode>/ours_<it>/{renders,mask}/NN.png``
    and ``depth/<scene>/<mode>/NN.png``."""

    def __init__(self, data_root: str, size=(512, 384),
                 motion_bucket_id=127, fps_id=6, num_frames=14,
                 cond_aug=0.0, modes=("x1", "x2"), iteration=30000,
                 hint_mode: str = "full"):
        self.hint_mode = hint_mode
        self.root = data_root
        self.size = tuple(size)
        self.motion_bucket_id = motion_bucket_id
        self.fps_id = fps_id
        self.num_frames = num_frames
        self.cond_aug = cond_aug
        self.modes = list(modes)
        self.iteration = iteration
        scenes = sorted(os.listdir(os.path.join(data_root, "ctrl1")))
        self.items: List[Tuple[str, str]] = []
        for scene in scenes:
            for ctrl in sorted(os.listdir(
                    os.path.join(data_root, "ctrl1", scene))):
                self.items.append((scene, ctrl))

    def __len__(self):
        return len(self.items) * len(self.modes)

    def meta(self, index) -> Tuple[str, str, str]:
        scene, ctrl = self.items[index // len(self.modes)]
        return scene, ctrl, self.modes[index % len(self.modes)]

    def __getitem__(self, index) -> Dict:
        scene, ctrl, mode = self.meta(index)
        seq = os.path.join(self.root, "seq", scene, mode,
                           f"ours_{self.iteration}")
        depth = os.path.join(self.root, "depth", scene, mode)
        cond = _load(os.path.join(self.root, "ctrl1", scene, ctrl),
                     self.size)
        frames, controls, masks = [], [], []
        for i in range(self.num_frames):
            v = f"{i:02d}"
            frames.append(_load(f"{seq}/renders/{v}.png", self.size))
            controls.append(_load(f"{depth}/{v}.png", self.size,
                                  scale=False))
            masks.append(_load(f"{seq}/mask/{v}.png", self.size,
                               scale=False, grayscale=True))
        return _video_batch(frames, controls, masks, cond, self.fps_id,
                            self.motion_bucket_id, self.cond_aug,
                            hint_mode=self.hint_mode)


class EstSVDForwardDataset:
    """Training dataset over synthetic %09d scene directories.

    ``mask_shrink_k`` > 0 enables the reference's random mask-shrink
    augmentation (:func:`process_mask`, k_max=``mask_shrink_k``).
    ``pose_cond`` emits ``azimuths_rad``/``polars_rad``/``rad`` computed
    from each scene's ``poses.npy`` via :func:`compute_poses` (SV3D-style
    vector conditioning; reference dataset variants at
    ``my_dataset.py:351-366``); ``pose_fn="v2"`` uses
    :func:`compute_poses2` (SV3D wrapped ranges, the SV3D*Dataset
    variants). ``depth_dir`` selects the control-image directory —
    ``est_depth`` (Est* family), ``depth`` (rendered-depth family) or
    ``disparity`` (SVDForwardDataset3, my_dataset.py:2812-2895).
    ``reversal=False`` disables the sequence-reversal augmentation (the
    Least/Inpaint variants sample forward only). ``sample_id`` pins
    every draw to one scene and ``repeat`` sets the epoch length
    (BlendingDataset my_dataset.py:2896-2969 / SingleVideoDataset:142)."""

    def __init__(self, data_root: str, size=(512, 384),
                 motion_bucket_id=127, fps_id=6, num_frames=14,
                 cond_aug=0.0, seed=0, hint_mode: str = "full",
                 mask_shrink_k: float = 0.0, pose_cond: bool = False,
                 pose_fn: str = "v1", depth_dir: str = "est_depth",
                 reversal: bool = True, sample_id: int | None = None,
                 repeat: int = 1, hint_frames_dir: str | None = None):
        self.hint_mode = hint_mode
        self.root = data_root
        self.size = tuple(size)
        self.motion_bucket_id = motion_bucket_id
        self.fps_id = fps_id
        self.num_frames = num_frames
        self.cond_aug = cond_aug
        self.mask_shrink_k = mask_shrink_k
        self.pose_cond = pose_cond
        self.pose_fn = pose_fn
        self.depth_dir = depth_dir
        self.reversal = reversal
        self.sample_id = sample_id
        self.repeat = repeat
        self.hint_frames_dir = hint_frames_dir
        self.scene_ids = sorted(os.listdir(data_root))
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)

    def __len__(self):
        if self.sample_id is not None:
            return int(self.repeat)
        return len(self.scene_ids) * int(self.repeat)

    def _maybe_shrink(self, mask):
        if self.mask_shrink_k <= 0:
            return mask
        shrunk = process_mask(mask[..., 0], self.mask_shrink_k, self.rng)
        return mask if shrunk is None else shrunk[..., None]

    def __getitem__(self, index) -> Dict:
        if self.sample_id is not None:
            index = self.sample_id
        else:
            index = index % len(self.scene_ids)
        root = os.path.join(self.root, f"{index:09d}")
        frames, controls, masks, hframes = [], [], [], []
        for i in range(self.num_frames):
            v = f"{i:05d}"
            frames.append(_load(f"{root}/rgb/{v}.png", self.size))
            controls.append(_load(f"{root}/{self.depth_dir}/{v}.png",
                                  self.size, scale=False))
            masks.append(self._maybe_shrink(
                _load(f"{root}/masks/{v}.png", self.size,
                      scale=False, grayscale=True)))
            if self.hint_frames_dir:
                hframes.append(_load(
                    f"{root}/{self.hint_frames_dir}/{v}.png", self.size))
        poses = (np.load(os.path.join(root, "poses.npy"))
                 if self.pose_cond else None)
        if self.reversal and self.rng.random() > 0.5:  # reversal aug
            frames.reverse()
            controls.reverse()
            masks.reverse()
            hframes.reverse()
            if poses is not None:
                poses = poses[::-1]
        cond = frames[0].copy()
        batch = _video_batch(frames, controls, masks, cond, self.fps_id,
                             self.motion_bucket_id, self.cond_aug,
                             rng=self.np_rng if self.cond_aug > 0 else
                             None, hint_mode=self.hint_mode,
                             hint_frames=hframes or None)
        if poses is not None:
            fn = compute_poses2 if self.pose_fn == "v2" else compute_poses
            cc_path = os.path.join(root, "cam_center.npy")
            cc = np.load(cc_path) if os.path.exists(cc_path) else None
            az, po, rad = fn(poses, cam_center=cc)
            batch["azimuths_rad"] = az.astype(np.float32)
            batch["polars_rad"] = po.astype(np.float32)
            batch["rad"] = rad.astype(np.float32)
        return batch


class WarpSVDForwardDataset:
    """Warp-consistency training dataset (reference
    ``SVDForwardLeastDataset3``, ``my_dataset.py:1954-2099``).

    Scene contract: ``%09d/{rgb,depth,masks}/%05d.png`` + ``poses.npy``
    (camera-to-world [T,4,4]) + ``metadata`` JSON ``{"w","h","K"}`` (K
    column-major 3x3 at the raw resolution, like the reference's
    ``meta["K"].reshape(3,3).T``). depth PNGs are uint16 millimetres
    (scale 1000, clipped to [0, 5] m).

    Emits the standard video batch (hint = frames*(1-mask), the
    reference's 3-channel variant) plus ``hit_map``/``uv_ind`` warp maps
    at the latent resolution (k_scale = 8) for
    ``diffusion.losses.warp_consistency_loss``. Train mode applies the
    mask-shrink augmentation; the reversal augmentation reverses poses
    too."""

    DEPTH_SCALE = 1000.0
    DEPTH_MAX = 5.0
    K_SCALE = 8

    def __init__(self, data_root: str, size=(512, 384),
                 motion_bucket_id=127, fps_id=6, num_frames=14,
                 cond_aug=0.0, seed=0, train: bool = True,
                 mask_shrink_k: float = 0.4):
        self.root = data_root
        self.size = tuple(size)
        self.motion_bucket_id = motion_bucket_id
        self.fps_id = fps_id
        self.num_frames = num_frames
        self.cond_aug = cond_aug
        self.train = train
        self.mask_shrink_k = mask_shrink_k
        self.scene_ids = sorted(os.listdir(data_root))
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.scene_ids)

    def __getitem__(self, index) -> Dict:
        import json

        from PIL import Image

        from .warp import compute_warp_maps

        root = os.path.join(self.root, f"{index:09d}")
        frames, depths, masks = [], [], []
        for i in range(self.num_frames):
            v = f"{i:05d}"
            frames.append(_load(f"{root}/rgb/{v}.png", self.size))
            depths.append(np.asarray(
                Image.open(f"{root}/depth/{v}.png"), dtype=np.uint16))
            m = _load(f"{root}/masks/{v}.png", self.size, scale=False,
                      grayscale=True)
            if self.train:
                shrunk = process_mask(m[..., 0], self.mask_shrink_k,
                                      self.rng)
                m = m if shrunk is None else shrunk[..., None]
            masks.append(m)
        poses = np.load(os.path.join(root, "poses.npy")).astype(np.float64)

        if self.rng.random() > 0.5:  # reversal aug (poses too)
            frames.reverse()
            depths.reverse()
            masks.reverse()
            poses = poses[::-1].copy()

        depth_m = np.clip(np.stack(depths).astype(np.float32)
                          / self.DEPTH_SCALE, 0.0, self.DEPTH_MAX)
        cond = frames[0].copy()
        batch = _video_batch(frames, [f * 0 for f in frames], masks, cond,
                             self.fps_id, self.motion_bucket_id,
                             self.cond_aug,
                             rng=self.np_rng if self.cond_aug > 0 else
                             None, hint_mode="frames_only")

        with open(os.path.join(root, "metadata")) as f:
            meta = json.load(f)
        # K stored column-major at the raw (meta w/h) resolution, which is
        # the resolution the depth PNGs carry; compute_warp_maps rescales
        # it to the latent grid itself (the reference bakes the same
        # rescale into k_resize, my_dataset.py:2060-2062).
        K = np.asarray(meta["K"], np.float64).reshape(3, 3).T
        h8 = self.size[0] // self.K_SCALE
        w8 = self.size[1] // self.K_SCALE
        hit_map, uv_ind = compute_warp_maps(
            depth_m, poses, K, latent_hw=(h8, w8), channels=4)
        batch["hit_map"] = hit_map
        batch["uv_ind"] = uv_ind
        return batch


def epoch_iterator(dataset, shuffle=True, seed=0):
    order = list(range(len(dataset)))
    if shuffle:
        random.Random(seed).shuffle(order)
    for i in order:
        yield i, dataset[i]
