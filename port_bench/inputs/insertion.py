"""The SDS cell's scene: an object inserted into a splat scene, as stage
1 of the pipeline leaves it for ``sds_train``.

The layout of ``inputs.scene`` (the configuration's size, SH degree and
``layout_seed``) with an axis-aligned insertion box of the configured
side at the orbit's focus. The layout's rows inside the box are deleted
by the program's own test (``gs/obb.contains``, as ``delete`` does), and
``n_samples`` rows are added inside it by ``gs/scene.load_sd_ply``'s
rule: uniform in the box (the program's ``obb.sample_uniform``, from the
run's seed), grey (zero SH), opacity 0.1, identity rotation, and an
isotropic log-scale from the mean squared distance to their 3 nearest
neighbours among the new rows (the program's ``ops.knn``), clipped at
1e-7. Each view's mask is the program's ``gen_seq.box_mask`` against
the depth of the reference's render of the background (the scene
without the new rows). The background-preserving loss's targets are the
reference's renders of that background seeded slightly off
(``scene.perturb``, as the train cell's targets), so that the loss's
gradients are those of a background near convergence and not of
round-off, where the render would equal its target. Both the program and
the reference get these tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import scene as scene_mod

CHUNK = 1 << 16


def box_of(cfg: dict):
    from multiview_inpaint_tpu_torch.gs import obb
    b = cfg["box"]
    return obb.from_center_axes(np.asarray(b["center"], np.float32),
                                b["side"] * np.eye(3, dtype=np.float32))


def insertion_scene(cfg: dict, seed: int, box_seed: int, device):
    """(scene fields with the new rows last, background fields, number
    of new rows)."""
    from multiview_inpaint_tpu_torch.gs import obb
    from multiview_inpaint_tpu_torch.ops.knn import knn_mean_sq_dist
    box = box_of(cfg)
    fields = scene_mod.make_scene(cfg["num_gaussians"], cfg["sh_degree"],
                                  cfg["layout_seed"], seed, device)
    xyz = fields["xyz"]
    inside = torch.cat([obb.contains(box, xyz[i:i + CHUNK])
                        for i in range(0, xyz.shape[0], CHUNK)])
    bg = {k: v[~inside].contiguous() for k, v in fields.items()}
    n = cfg["box"]["n_samples"]
    g = torch.Generator(device=device).manual_seed(box_seed)
    new_xyz = obb.sample_uniform(box, g, n)
    d2 = torch.clamp(knn_mean_sq_dist(new_xyz), min=1e-7)
    m = (cfg["sh_degree"] + 1) ** 2 - 1
    rot = torch.zeros((n, 4), device=device)
    rot[:, 0] = 1.0
    new = {"xyz": new_xyz,
           "features_dc": torch.zeros((n, 1, 3), device=device),
           "features_rest": torch.zeros((n, m, 3), device=device),
           "opacity": torch.full((n, 1), math.log(0.1 / 0.9),
                                 device=device),
           "scaling": torch.log(torch.sqrt(d2))[:, None].repeat(1, 3),
           "rotation": rot}
    scene = {k: torch.cat([bg[k], new[k]]).contiguous() for k in bg}
    return scene, bg, n


def masks_and_targets(cfg: dict, bg: dict, target: dict, cams, render):
    """Each view's box mask [H, W] against the depth of ``bg`` and its
    target [H, W, 3], the render of ``target``: ``render(fields, cam)``
    gives (rgb, depth)."""
    from multiview_inpaint_tpu_torch.gs.cameras import Camera
    from multiview_inpaint_tpu_torch.pipelines.gen_seq import box_mask
    box = box_of(cfg)
    masks, targets = [], []
    for c in cams:
        depth = render(bg, c)[1]
        rgb = render(target, c)[0]
        view = Camera(uid=0, image_name="", width=c.width, height=c.height,
                      fovx=2 * math.atan(c.tan_fovx),
                      fovy=2 * math.atan(c.tan_fovy),
                      world_view=c.world_view.double().cpu().numpy())
        masks.append(box_mask(view, box, depth))
        targets.append(rgb)
    return masks, targets
