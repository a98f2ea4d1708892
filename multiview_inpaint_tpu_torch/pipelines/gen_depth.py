"""Depth hints for the coarse-model renders — reference ``gen_depth.py``.

Port of ``multiview_inpaint_tpu/pipelines/gen_depth.py``. By default it
renders the coarse SDS model's exact disparity at the orbit poses (1 /
depth, empty pixels 0, divided by the frame's largest); ``--dpt_ckpt``
runs the DPT monocular depth network over the renders instead (the
reference's HF ``pipeline('depth-estimation')``); ``--from_est <dir>``
copies externally computed maps (``<mode>/NN.png``).

Writes ``inpaint/depth/<scene_case>/<mode>/NN.png`` (3-channel normalised
disparity), the control hint that ``ctrl_inpaint`` and the SVD datasets
read.

    python -m multiview_inpaint_tpu_torch.pipelines.gen_depth \\
        --scene_id <scene>_<case> --sds_model output_sds/<scene>_<case> \\
        -s dataset/<scene> -m output/<scene> [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from ..gs import gaussians as g_mod
from ..gs import obb as obb_mod
from ..gs import scene_io
from ..gs.scene import Scene, Workspace, orbit_cameras
from ..ops.rasterizer import DEPTH_EMPTY, RenderCamera, render
from ..utils.device import resolve_device
from . import common


def disparity(depth: np.ndarray) -> np.ndarray:
    """A rendered depth map as normalised disparity: 1 / max(depth, 0.1),
    0 on empty pixels, divided by its largest value."""
    disp = 1.0 / np.clip(depth, 0.1, None)
    disp[depth >= DEPTH_EMPTY - 1e-3] = 0.0
    if disp.max() > 0:
        disp = disp / disp.max()
    return disp


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(parser)
    common.add_registry_arg(parser)
    parser.add_argument("--scene_id", required=True)
    parser.add_argument("--sds_model", default=None,
                        help="coarse model dir (output_sds/<scene_case>)")
    parser.add_argument("--sds_iteration", type=int, default=5000)
    parser.add_argument("--from_est", default=None,
                        help="import external depth maps "
                             "(<mode>/NN.png) instead of rendering")
    parser.add_argument("--dpt_ckpt", default=None,
                        help="torch DPTForDepthEstimation checkpoint: run "
                             "the DPT depth network over the coarse "
                             "renders (the reference's behaviour) instead "
                             "of the exact rendered disparity")
    parser.add_argument("--dpt_size", type=int, default=384,
                        help="DPT processor grid (HF default 384)")
    parser.add_argument("--modes", nargs="+", default=["x1", "x2"])
    parser.add_argument("--frames", type=int, default=14)
    parser.add_argument("--workspace", default=".")
    parser.add_argument("--inpaint_root", default="inpaint")
    common.add_device_arg(parser)
    common.add_orbit_args(parser)
    args = parser.parse_args(argv)
    common.apply_registry(args)
    # fail fast on unknown scene ids (reference raises KeyError)
    orbit = common.resolve_orbit(args)

    ws = Workspace(args.workspace, args.inpaint_root)
    if args.from_est:
        for mode in args.modes:
            out_dir = ws.depth_dir(args.scene_id, mode)
            os.makedirs(out_dir, exist_ok=True)
            src = os.path.join(args.from_est, mode)
            for f in sorted(os.listdir(src)):
                shutil.copy(os.path.join(src, f),
                            os.path.join(out_dir, f))
            print(f"imported {mode} depth -> {out_dir}")
        return

    dev = resolve_device(args.device)
    sds_model = args.sds_model or os.path.join("output_sds", args.scene_id)
    ply = os.path.join(sds_model, "point_cloud",
                       f"iteration_{args.sds_iteration}", "point_cloud.ply")
    params = g_mod.load_ply(ply, args.sh_degree, device=dev)
    scene = Scene(args.source_path, args.model_path,
                  resolution=args.resolution, max_sh_degree=args.sh_degree,
                  shuffle=False, load_iteration=None, workspace=ws,
                  load_gaussians=False, device=dev)
    scene.scene_name = args.scene_id
    box = obb_mod.load_obb(ws.bds_add(args.scene_id))
    front = scene.front_view()
    bg = common.default_background(args.white_background, dev)
    dpt = None
    if args.dpt_ckpt:
        from ..models.dpt import estimate_depth, load_dpt_torch
        _, dpt_model = load_dpt_torch(args.dpt_ckpt, device=dev)

        def dpt(rgb):
            return estimate_depth(dpt_model, rgb, proc_size=args.dpt_size)
    for mode in args.modes:
        views = orbit_cameras(
            front, box, mode=mode, frames=args.frames,
            view_range=orbit.view_range if orbit else np.pi / 3,
            r_scale=orbit.r_scale if orbit else 1.0,
            k_lift=orbit.k_lift if orbit else 0.0,
            k_bias=orbit.k_bias if orbit else 0.0)
        out_dir = ws.depth_dir(args.scene_id, mode)
        os.makedirs(out_dir, exist_ok=True)
        for view in views:
            out = render(params, RenderCamera.from_camera(view, dev), bg,
                         sh_degree=args.sh_degree, device=dev)
            if dpt is not None:
                disp = dpt(np.clip(out.rgb.detach().cpu().numpy(), 0.0, 1.0))
            else:
                disp = disparity(out.depth.detach().cpu().numpy())
            scene_io.save_image(
                os.path.join(out_dir, f"{view.image_name}.png"),
                np.repeat(disp[..., None], 3, axis=-1))
        print(f"{mode}: {len(views)} depth hints -> {out_dir}")


if __name__ == "__main__":
    main()
