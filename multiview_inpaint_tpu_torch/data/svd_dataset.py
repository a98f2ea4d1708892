"""The SVD multi-view inpainting inference dataset (host-side numpy, NHWC).

The port's own copy of what ``svd_test`` needs from
``multiview_inpaint_tpu/data/svd_dataset.py`` (a numpy-only module):
:class:`GSVideoForwardDataset` (the reference's
GS_VideoForwardDatasetSimp), which, for every curated control image
``<root>/ctrl1/<scene>/<ctrl>.png`` and orbit mode, loads the 14 orbit
renders, estimated depths and box masks and builds the 7-channel
``control_hint = [depth(3) | mask(1) | frames*(1-mask)(3)]``, with
``_load``, ``HINT_MODES``, ``_video_batch`` and ``process_mask``.

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
