"""Video-trajectory rendering of source/reconstructed models.

Reference ``gs-simp/vis_render.py``: renders a smooth orbit (VIS_PARAMS
per scene) around the insertion box for the original background model
(``--src``) or a stage-2 reconstruction, writing frames under
``vis/vis_video/{src,inpainted}/<scene_case>[/ctrl_k]/renders``.

    python -m multiview_inpaint_tpu_torch.pipelines.vis_render \
        --scene_id <scene>_<case> -s dataset/<scene> -m <model_dir> \
        [--src] [--ctrl_id K] [--frames 56] [--device cuda|cpu]

Port of ``multiview_inpaint_tpu/pipelines/vis_render.py``.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..config.registries import VIS_PARAMS, OrbitParams
from ..gs import gaussians as g_mod
from ..gs import obb as obb_mod
from ..gs import scene_io
from ..gs.scene import Scene, Workspace, orbit_cameras
from ..ops.rasterizer import RenderCamera, render
from ..utils.device import resolve_device
from . import common


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(parser)
    common.add_registry_arg(parser)
    parser.add_argument("--scene_id", required=True)
    parser.add_argument("--src", action="store_true",
                        help="render the background model (no object)")
    parser.add_argument("--ctrl_id", type=int, default=0)
    parser.add_argument("--rec_model", default=None,
                        help="output_rec dir (defaults derived)")
    parser.add_argument("--iteration", type=int, default=30000)
    parser.add_argument("--frames", type=int, default=56)
    parser.add_argument("--workspace", default=".")
    parser.add_argument("--inpaint_root", default="inpaint",
                        help="inpaint hand-off dir (abs or relative to workspace)")
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    common.apply_registry(args)

    ws = Workspace(args.workspace, args.inpaint_root)
    scene = Scene(args.source_path, args.model_path,
                  resolution=args.resolution, max_sh_degree=args.sh_degree,
                  shuffle=False, load_iteration=None, workspace=ws,
                  load_gaussians=False)
    scene.scene_name = args.scene_id
    box = obb_mod.load_obb(ws.bds_add(args.scene_id))
    vis = VIS_PARAMS.get(args.scene_id.split("_")[0], OrbitParams())

    if args.src:
        ply = os.path.join(args.model_path, "point_cloud",
                           f"iteration_{args.iteration}", "point_cloud.ply")
        tag = "src"
        out_leaf = args.scene_id
    else:
        rec = args.rec_model or os.path.join("output_rec", args.scene_id,
                                             f"ctrl_{args.ctrl_id}")
        ply = os.path.join(rec, "point_cloud",
                           f"iteration_{args.iteration}", "point_cloud.ply")
        tag = "inpainted"
        out_leaf = os.path.join(args.scene_id, f"ctrl_{args.ctrl_id}")
    params = g_mod.load_ply(ply, args.sh_degree, device=dev)

    # full sweep: x1 reversed then x2 (continuous left-to-right orbit)
    front = scene.front_view()
    half = args.frames // 2
    v1 = orbit_cameras(front, box, mode="x1", frames=half,
                       view_range=vis.view_range, r_scale=vis.r_scale,
                       k_lift=vis.k_lift, k_bias=vis.k_bias)
    v2 = orbit_cameras(front, box, mode="x2", frames=args.frames - half,
                       view_range=vis.view_range, r_scale=vis.r_scale,
                       k_lift=vis.k_lift, k_bias=vis.k_bias)
    views = list(reversed(v1)) + v2[1:]

    out_dir = os.path.join(args.workspace, "vis", "vis_video", tag,
                           out_leaf, "renders")
    os.makedirs(out_dir, exist_ok=True)
    bg = common.default_background(args.white_background, dev)
    for i, view in enumerate(views):
        with torch.no_grad():
            rgb = render(params, RenderCamera.from_camera(view, dev), bg,
                         sh_degree=args.sh_degree, device=dev).rgb
        scene_io.save_image(os.path.join(out_dir, f"{i:05d}.png"),
                            torch.clamp(rgb, 0, 1).cpu().numpy())
    print(f"{len(views)} frames -> {out_dir}")


if __name__ == "__main__":
    main()
