"""Stage-2 object reconstruction — reference ``gs-simp/inpaint_rec.py``.

Port of ``multiview_inpaint_tpu/pipelines/inpaint_rec.py``: loads the
del-background PLY plus ``--n_samples`` gaussians seeded uniformly in the
insertion box (``load_sd_ply``), then trains against the
multi-view-inpainted orbit frames (full-image L1+SSIM) and the original
training views (the loss on the background only, the box mask out), with
the stage-1 densification schedule. Output:
``<model>/ctrl_<k>/point_cloud/iteration_N/point_cloud.ply`` and the
JSONL log ``train_log.jsonl`` beside it.

    python -m multiview_inpaint_tpu_torch.pipelines.inpaint_rec \\
        --scene_id <scene>_<case> --ctrl_id K -s dataset/<scene> \\
        -m output_rec/<scene>_<case> --bg_model output/<scene> \\
        [--device cuda|cpu]

The JAX CLI's TPU knobs (``--backend``, ``--max_per_tile``,
``--pair_budget_mult``) and its pair-budget growth are gone, as in the
port's ``train_gs``: the port's pair count is exact. The box samples and
the densification draws come from torch generators, not JAX keys.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from ..gs import gaussians as g_mod
from ..gs import obb as obb_mod
from ..gs import scene as scene_mod
from ..gs.scene import Scene, Workspace
from ..models import gs_trainer
from ..ops.rasterizer import RenderCamera
from ..utils.device import resolve_device
from ..utils.logging import RunLogger
from . import common


def _tensor(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def train(args):
    dev = resolve_device(args.device)
    ws = Workspace(args.workspace, args.inpaint_root)
    scene = Scene(args.source_path, args.bg_model,
                  resolution=args.resolution, max_sh_degree=args.sh_degree,
                  shuffle=False, load_iteration=None, workspace=ws,
                  load_gaussians=False, device=dev)
    scene.scene_name = args.scene_id
    box = obb_mod.load_obb(ws.bds_add(args.scene_id))
    del_ply = os.path.join(args.bg_model, "point_cloud", "del",
                           "point_cloud.ply")
    params = scene_mod.load_sd_ply(del_ply, box, n_samples=args.n_samples,
                                  max_sh_degree=args.sh_degree, device=dev)
    cams = scene_mod.inpaint_train_cameras(
        scene, n_mode=args.n_mode, ctrl_id=args.ctrl_id,
        frames=args.frames, iteration=args.bg_iteration)
    if not cams:
        raise SystemExit("no inpaint training cameras found — run gen_seq "
                         "and svd_test first")

    out_dir = os.path.join(args.model_path, f"ctrl_{args.ctrl_id}")
    os.makedirs(out_dir, exist_ok=True)
    logger = RunLogger(out_dir)
    cfg = common.optimization_config_from(args)
    state = gs_trainer.init_state(params)
    bg = common.default_background(args.white_background, dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    rng = random.Random(0)
    stack = []
    for iteration in range(1, cfg.iterations + 1):
        if not stack:
            stack = list(cams)
            rng.shuffle(stack)
        cam = stack.pop()
        rcam = RenderCamera.from_camera(cam, dev)
        gt = _tensor(cam.image, dev)
        if cam.inpainted:
            state, metrics = gs_trainer.train_step(
                state, rcam, gt, bg, cfg,
                spatial_lr_scale=scene.cameras_extent,
                sh_degree=args.sh_degree, loss_mode="full")
        else:
            state, metrics = gs_trainer.train_step(
                state, rcam, gt, bg, cfg,
                spatial_lr_scale=scene.cameras_extent,
                sh_degree=args.sh_degree, mask=_tensor(cam.mask, dev),
                loss_mode="background")
        state, info = gs_trainer.maybe_densify(state, generator, cfg,
                                               scene.cameras_extent,
                                               iteration)
        state = gs_trainer.grow_if_needed(state, info)
        if iteration % args.log_interval == 0:
            logger.log(iteration, loss=metrics.loss, pairs=metrics.pairs,
                       points=int(metrics.num_live),
                       capacity=state.params.capacity,
                       nonfinite_grads=int(metrics.nonfinite_grads),
                       **(info or {}))
        if iteration in args.save_iterations:
            path = os.path.join(out_dir, "point_cloud",
                                f"iteration_{iteration}",
                                "point_cloud.ply")
            g_mod.save_ply(state.params, path)
            logger.echo(f"[ITER {iteration}] saved {path}")
    logger.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(parser)
    common.add_optimization_args(parser)
    common.add_registry_arg(parser)
    parser.add_argument("--scene_id", required=True)
    parser.add_argument("--ctrl_id", type=int, default=-1)
    parser.add_argument("--bg_model", required=True,
                        help="stage-1 model dir (output/<scene>)")
    parser.add_argument("--bg_iteration", type=int, default=30000)
    parser.add_argument("--workspace", default=".")
    parser.add_argument("--inpaint_root", default="inpaint",
                        help="inpaint hand-off dir (abs or relative to workspace)")
    parser.add_argument("--n_mode", type=int, default=2)
    parser.add_argument("--frames", type=int, default=14)
    parser.add_argument("--n_samples", type=int, default=30000)
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7000, 30000])
    parser.add_argument("--log_interval", type=int, default=100)
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    common.apply_registry(args)
    if args.iterations not in args.save_iterations:
        args.save_iterations = list(args.save_iterations) + [args.iterations]
    train(args)


if __name__ == "__main__":
    main()
