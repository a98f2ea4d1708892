"""Disparity rendering of orbit sequences — reference ``render_depth.py``.

Writes ``disp/NN.png`` (normalized 1/clamped-depth) next to the seq
renders, used for depth-hint debugging.

    python -m multiview_inpaint_tpu_torch.pipelines.render_depth \
        --scene_id <scene>_<case> -m output/<scene> -s dataset/<scene> \
        [--device cuda|cpu] [--shard_views]

Port of ``multiview_inpaint_tpu/pipelines/render_depth.py``; the
disparity ``1/clip(depth, 0.1)`` over its max is taken on the device.
``--shard_views`` under torchrun at a world size above 1 renders the
views in groups of one per rank and rank 0 writes; at world size 1 it
changes nothing.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..gs import obb as obb_mod
from ..gs import scene_io
from ..gs.scene import Scene, Workspace, orbit_cameras
from ..ops.rasterizer import RenderCamera, render
from ..parallel import mesh
from ..parallel.render_parallel import views_sharded
from ..utils.device import resolve_device
from . import common


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(parser)
    parser.add_argument("--scene_id", required=True)
    common.add_registry_arg(parser)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--workspace", default=".")
    parser.add_argument("--inpaint_root", default="inpaint",
                        help="inpaint hand-off dir (abs or relative to workspace)")
    parser.add_argument("--modes", nargs="+", default=["x1", "x2"])
    parser.add_argument("--frames", type=int, default=14)
    parser.add_argument("--shard_views", action="store_true",
                        help="shard orbit views over all devices "
                             "(params replicated)")
    common.add_device_arg(parser)
    common.add_orbit_args(parser)
    args = parser.parse_args(argv)
    dev = (mesh.init_from_env(args.device) if args.shard_views
           else resolve_device(args.device))
    common.apply_registry(args)
    # fail fast on unknown scene ids (reference raises KeyError)
    orbit = common.resolve_orbit(args)

    ws = Workspace(args.workspace, args.inpaint_root)
    scene = Scene(args.source_path, args.model_path,
                  resolution=args.resolution, max_sh_degree=args.sh_degree,
                  shuffle=False, load_iteration=args.iteration,
                  workspace=ws, device=dev)
    scene.scene_name = args.scene_id
    iteration = scene.loaded_iteration or args.iteration
    box = obb_mod.load_obb(ws.bds_add(args.scene_id))
    bg = common.default_background(args.white_background, dev)
    front = scene.front_view()

    for mode in args.modes:
        views = orbit_cameras(
            front, box, mode=mode, frames=args.frames,
            view_range=orbit.view_range, r_scale=orbit.r_scale,
            k_lift=orbit.k_lift, k_bias=orbit.k_bias)
        out_dir = os.path.join(args.workspace, "inpaint", "seq",
                               args.scene_id, mode, f"ours_{iteration}",
                               "disp")
        os.makedirs(out_dir, exist_ok=True)
        with torch.no_grad():
            if args.shard_views and mesh.world() > 1:
                outs = views_sharded(scene.gaussians, views, bg, device=dev,
                                     sh_degree=args.sh_degree)
            else:
                outs = ((i, render(scene.gaussians, RenderCamera.from_camera(
                    v, dev), bg, sh_degree=args.sh_degree, device=dev))
                    for i, v in enumerate(views))
            for i, out in outs:
                if mesh.rank() != 0:
                    continue
                disp = 1.0 / torch.clamp(out.depth, min=0.1)
                disp = disp / disp.max()
                scene_io.save_image(
                    os.path.join(out_dir, f"{views[i].image_name}.png"),
                    disp.cpu().numpy())
        print(f"mode {mode}: disparity -> {out_dir}")


if __name__ == "__main__":
    main()
