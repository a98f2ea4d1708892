"""Seeded inputs of one inpainted clip, made on the device.

What ``svd_test`` reads for one scene x candidate x mode, at the clip's
sizes: 14 background frames in [-1, 1], their estimated depth in [0, 1],
a box mask per frame (1 inside), the conditioning frame, the 7-channel
control hint (depth 3 | mask 1 | frames x (1 - mask) 3), the sampler's
initial noise and the conditioning augmentation's noise. Every clip has
the same sizes; the seed changes the content only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _smooth(g, n, c, h, w, cell, device):
    coarse = torch.randn((n, c, max(1, h // cell), max(1, w // cell)),
                         generator=g,
                         device=device)
    return F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def clip_inputs(seed: int, frames: int, height: int, width: int, device,
                fps_id: float = 6.0, motion_bucket_id: float = 127.0,
                cond_aug: float = 0.0) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    t, h, w = frames, height, width
    video = torch.tanh(_smooth(g, t, 3, h, w, 32, device)
                       + 0.1 * torch.randn((t, h, w, 3), generator=g,
                                           device=device))
    cond = torch.tanh(_smooth(g, 1, 3, h, w, 32, device))
    depth = torch.sigmoid(_smooth(g, t, 1, h, w, 64, device)).expand(
        t, h, w, 3)
    box = torch.rand(4, generator=g, device=device)
    cy, cx = 0.3 + 0.4 * box[0], 0.3 + 0.4 * box[1]
    hh, hw = 0.15 + 0.15 * box[2], 0.15 + 0.15 * box[3]
    drift = 0.02 * torch.randn((t, 2), generator=g, device=device)
    ys = (torch.arange(h, device=device) + 0.5) / h
    xs = (torch.arange(w, device=device) + 0.5) / w
    in_y = (ys[None] - (cy + drift[:, :1])).abs() <= hh
    in_x = (xs[None] - (cx + drift[:, 1:])).abs() <= hw
    mask = (in_y[:, :, None] & in_x[:, None, :]).float()[..., None]
    hint = torch.cat([depth, mask, video * (1 - mask)], dim=-1)
    one = torch.ones((1,), device=device)
    batch = {"jpg": video, "control_hint": hint, "masks": mask,
             "cond_frames_without_noise": cond, "cond_frames": cond,
             "fps_id": fps_id * one, "motion_bucket_id": motion_bucket_id
             * one, "cond_aug": cond_aug * one}
    noise = torch.randn((t, h // 8, w // 8, 4), generator=g, device=device)
    aug = torch.randn(cond.shape, generator=g, device=device)
    return {"batch": batch, "noise": noise, "aug_noise": aug}
