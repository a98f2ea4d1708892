"""Render train/test sets from a trained model — reference ``render.py``.

    python -m multiview_inpaint_tpu_torch.pipelines.render -m output/<scene> \
        [--iteration N] [--skip_train] [--skip_test] [--device cuda|cpu]
    torchrun --nproc_per_node N -m multiview_inpaint_tpu_torch.pipelines.render \
        -m output/<scene> --shard_views

Port of ``multiview_inpaint_tpu/pipelines/render.py``: loads the PLY
checkpoint through the scene cascade and writes one PNG per view (and
optionally a normalised disparity PNG). With ``--shard_views`` under
torchrun at a world size above 1, the views are rendered in groups of one
view per rank (``parallel.render_parallel``) and rank 0 writes the files;
at world size 1 the flag changes nothing, as the JAX CLI on one device.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..gs import scene_io
from ..gs.scene import Scene
from ..ops.rasterizer import RenderCamera, render
from ..parallel import mesh
from ..parallel.render_parallel import views_sharded
from ..utils.device import DEFAULT_DEVICE, resolve_device
from . import common


def render_set(model_path, name, iteration, views, params, bg, sh_degree,
               save_depth=False, device=DEFAULT_DEVICE, shard=False):
    out_root = os.path.join(model_path, name, f"ours_{iteration}")
    render_dir = os.path.join(out_root, "renders")
    gt_dir = os.path.join(out_root, "gt")
    os.makedirs(render_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    # FOV and size are one render's statics: mixed cameras take the loop.
    uniform = len({(v.width, v.height, v.tan_half_fovx, v.tan_half_fovy)
                   for v in views}) == 1
    with torch.no_grad():
        if shard and uniform:
            outs = views_sharded(params, views, bg, device=device,
                                 sh_degree=sh_degree)
        else:
            outs = ((i, render(params, RenderCamera.from_camera(v, device),
                               bg, sh_degree=sh_degree, device=device))
                    for i, v in enumerate(views))
        for idx, out in outs:
            if mesh.rank() != 0:
                continue
            scene_io.save_image(os.path.join(render_dir, f"{idx:05d}.png"),
                                out.rgb.cpu().numpy())
            if views[idx].image is not None:
                scene_io.save_image(os.path.join(gt_dir, f"{idx:05d}.png"),
                                    views[idx].image)
            if save_depth:
                depth_dir = os.path.join(out_root, "depth")
                os.makedirs(depth_dir, exist_ok=True)
                disp = 1.0 / torch.clamp(out.depth, min=0.1)
                scene_io.save_image(
                    os.path.join(depth_dir, f"{idx:05d}.png"),
                    (disp / disp.max()).cpu().numpy())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(parser)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--save_depth", action="store_true")
    parser.add_argument("--shard_views", action="store_true",
                        help="shard view rendering over all devices "
                             "(uniform view sizes; params replicated)")
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    args = common.load_cfg(args.model_path, args, set())

    dev = (mesh.init_from_env(args.device) if args.shard_views
           else resolve_device(args.device))
    bg = common.default_background(args.white_background, dev)
    scene = Scene(args.source_path, args.model_path,
                  resolution=args.resolution, eval_split=args.eval,
                  max_sh_degree=args.sh_degree, shuffle=False,
                  load_iteration=args.iteration, device=dev)
    iteration = scene.loaded_iteration or args.iteration
    for name, views, skip in (("train", scene.train_cameras(),
                               args.skip_train),
                              ("test", scene.test_cameras(),
                               args.skip_test)):
        if not skip:
            render_set(args.model_path, name, iteration, views,
                       scene.gaussians, bg, args.sh_degree,
                       save_depth=args.save_depth, device=dev,
                       shard=args.shard_views and mesh.world() > 1)


if __name__ == "__main__":
    main()
