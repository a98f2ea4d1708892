"""Orbit sequence + box masks generation — reference ``gen_seq.py``.

For each orbit mode (x1, x2) renders the 14-frame sequence around the
insertion OBB and writes the directory contract consumed by the multi-view
inpainting stage:

    inpaint/seq/<scene_case>/<mode>/ours_<iter>/
        renders/NN.png   masked/NN.png   mask/NN.png
        poses.npy (c2w per frame)   cam_center.npy (box center)

plus ``bds_train`` masks for the real training views. Mask semantics are
the reference's exactly (``gen_seq.py:50``): box is visible where the ray
hits it closer than the rendered surface, or the pixel is empty
(depth == 15 sentinel).

    python -m multiview_inpaint_tpu_torch.pipelines.gen_seq \
        --scene_id <scene>_<case> -m output/<scene> -s dataset/<scene> \
        [--device cuda|cpu] [--shard_views]

Port of ``multiview_inpaint_tpu/pipelines/gen_seq.py``. Each view is
rendered, masked and written before the next one is rendered (the files
are the JAX CLI's), so a large training set never holds more than one
view's outputs on the device. With ``--shard_views`` under torchrun at a
world size above 1, the views are rendered in groups of one per rank
(``parallel.render_parallel.views_sharded``) and rank 0 masks and writes
them; at world size 1 the flag changes nothing.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..gs import obb as obb_mod
from ..gs import scene_io
from ..gs.cameras import get_rays
from ..gs.scene import Scene, Workspace, orbit_cameras
from ..ops.rasterizer import DEPTH_EMPTY, RenderCamera, render
from ..parallel import mesh
from ..parallel.render_parallel import views_sharded
from ..utils.device import DEFAULT_DEVICE, resolve_device
from . import common


def box_mask(view, box, depth: torch.Tensor) -> torch.Tensor:
    """[H, W] float mask of ``view`` on ``depth``'s device: the box's ray
    hit lies in front of the rendered ``depth``, or the pixel is empty."""
    rays_o, rays_d = get_rays(view)
    dev = depth.device
    _, t, _ = obb_mod.intersect(box, torch.from_numpy(rays_o).to(dev),
                                torch.from_numpy(rays_d).to(dev))
    t_img = t.reshape(view.height, view.width)
    return ((t_img > 0) & ((t_img < depth) | (depth == DEPTH_EMPTY))
            ).to(torch.float32)


def render_sequence(views, params, box, out_dir, bg, sh_degree=0,
                    save_poses=True, use_image_name=True,
                    device=DEFAULT_DEVICE, shard=False):
    """``shard``: render the views sharded over the ranks (uniform
    cameras); only rank 0 writes."""
    for sub in ("renders", "mask", "masked"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    poses = [view.camera_to_world for view in views]
    with torch.no_grad():
        if shard:
            outs = views_sharded(params, views, bg, device=device,
                                 sh_degree=sh_degree)
        else:
            outs = ((i, render(params, RenderCamera.from_camera(v, device),
                               bg, sh_degree=sh_degree, device=device))
                    for i, v in enumerate(views))
        for idx, out in outs:
            if mesh.rank() != 0:
                continue
            view = views[idx]
            v_id = view.image_name if use_image_name else f"{idx:02d}"
            mask = box_mask(view, box, out.depth)
            m = mask[..., None]
            masked = out.rgb * (1 - m) + m
            for sub, img in (("renders", out.rgb), ("mask", mask),
                             ("masked", masked)):
                scene_io.save_image(
                    os.path.join(out_dir, sub, f"{v_id}.png"),
                    img.cpu().numpy())
    if save_poses and mesh.rank() == 0:
        np.save(os.path.join(out_dir, "cam_center.npy"),
                np.asarray(box.center, np.float32)[None])
        np.save(os.path.join(out_dir, "poses.npy"),
                np.stack(poses).astype(np.float32))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(parser)
    parser.add_argument("--scene_id", required=True,
                        help="<scene>_<case>")
    common.add_registry_arg(parser)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--workspace", default=".")
    parser.add_argument("--inpaint_root", default="inpaint",
                        help="inpaint hand-off dir (abs or relative to workspace)")
    parser.add_argument("--modes", nargs="+", default=["x1", "x2"])
    parser.add_argument("--frames", type=int, default=14)
    parser.add_argument("--sds", action="store_true",
                        help="render the coarse SDS model sequence "
                             "(reads output_sds, writes inpaint_sds)")
    parser.add_argument("--shard_views", action="store_true",
                        help="shard orbit views over all devices "
                             "(data-axis mesh, params replicated)")
    common.add_device_arg(parser)
    common.add_orbit_args(parser)
    args = parser.parse_args(argv)
    dev = (mesh.init_from_env(args.device) if args.shard_views
           else resolve_device(args.device))
    shard = args.shard_views and mesh.world() > 1
    common.apply_registry(args)
    # fail fast on unknown scene ids (reference raises KeyError)
    orbit = common.resolve_orbit(args)

    ws = Workspace(args.workspace, args.inpaint_root)
    scene = Scene(args.source_path, args.model_path,
                  resolution=args.resolution, max_sh_degree=args.sh_degree,
                  shuffle=False, load_iteration=args.iteration,
                  workspace=ws, device=dev)
    # model dir is output/<scene>; outputs keyed by <scene>_<case>
    scene.scene_name = args.scene_id
    iteration = scene.loaded_iteration or args.iteration
    box = obb_mod.load_obb(ws.bds_add(args.scene_id))
    bg = common.default_background(args.white_background, dev)
    front = scene.front_view()

    seq_root = "inpaint_sds" if args.sds else "inpaint"
    for mode in args.modes:
        views = orbit_cameras(
            front, box, mode=mode, frames=args.frames,
            view_range=orbit.view_range, r_scale=orbit.r_scale,
            k_lift=orbit.k_lift, k_bias=orbit.k_bias)
        out_dir = os.path.join(args.workspace, seq_root, "seq",
                               args.scene_id, mode, f"ours_{iteration}")
        render_sequence(views, scene.gaussians, box, out_dir, bg,
                        sh_degree=args.sh_degree, use_image_name=True,
                        device=dev, shard=shard)
        print(f"mode {mode}: {len(views)} frames -> {out_dir}")

    if not args.sds:
        out_dir = os.path.join(args.workspace, "inpaint", "seq",
                               args.scene_id, "bds_train",
                               f"ours_{iteration}")
        render_sequence(scene.train_cameras(), scene.gaussians, box,
                        out_dir, bg, sh_degree=args.sh_degree,
                        save_poses=False, use_image_name=True, device=dev,
                        shard=shard)
        print(f"bds_train masks -> {out_dir}")


if __name__ == "__main__":
    main()
