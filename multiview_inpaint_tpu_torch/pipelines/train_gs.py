"""Background GS reconstruction CLI — reference ``gs-simp/train.py``.

    python -m multiview_inpaint_tpu_torch.pipelines.train_gs \\
        -s dataset/<scene> [-m output/<scene>] [--iterations 30000] \\
        [--device cuda|cpu] ...

Port of ``multiview_inpaint_tpu/pipelines/train_gs.py``: one train step
per iteration (render, L1+SSIM loss, backward through the composite
backward kernel on CUDA, grouped Adam); densification edits
fixed-capacity buffers and the capacity doubles under pressure;
checkpoints are PLY (the inter-stage contract, ``--save_iterations``)
plus full-state npz (``--checkpoint_iterations`` /
``--start_checkpoint``), in the JAX package's npz layout.

``--profile_dir`` writes a ``torch.profiler`` chrome trace of iterations
100-109 (``trace.json``) with the program's spans on (``telemetry``), so
that the trace shows them, and ``spans.json`` beside it: their sums per
name (``snapshot``) and the spans one by one (``records``).
``--detect_anomaly`` turns on autograd's anomaly detection.
``--live_view PORT`` serves a browser live view (``utils.live_view``):
every ``--live_interval`` iterations the current camera, or the pose the
browser posted, is rendered and published; other iterations add no host
sync. The
JAX CLI's TPU knobs (``--backend``, ``--max_per_tile``,
``--pair_budget_mult``, ``--expand_window``) and its pair-budget growth
are gone: the port's pair count is exact.
"""

from __future__ import annotations

import argparse
import math
import os
import random
import time

import numpy as np
import torch

from .. import telemetry
from ..gs import checkpoint as ckpt_mod
from ..gs.scene import Scene
from ..models import gs_trainer
from ..gs.cameras import retarget
from ..ops.rasterizer import RenderCamera, render
from ..utils import losses as loss_utils
from ..utils.device import resolve_device
from ..utils.live_view import LiveViewServer
from ..utils.logging import RunLogger
from . import common

PROFILE_FROM, PROFILE_TO = 100, 110


def _image(cam, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(cam.image, np.float32), device=dev)


def train(args) -> None:
    dev = resolve_device(args.device)
    model_path = args.model_path or os.path.join(
        "./output", os.path.basename(args.source_path.rstrip("/")))
    args.model_path = model_path
    os.makedirs(model_path, exist_ok=True)
    common.dump_cfg(model_path, args)
    logger = RunLogger(model_path)

    scene = Scene(args.source_path, model_path, resolution=args.resolution,
                  eval_split=args.eval, max_sh_degree=args.sh_degree,
                  white_background=args.white_background,
                  capacity=args.capacity, seed=0, device=dev)
    cfg = common.optimization_config_from(args)
    bg = common.default_background(args.white_background, dev)

    if args.start_checkpoint:
        state = ckpt_mod.load_train_state(args.start_checkpoint, dev)
        first_iter = state.step
    else:
        state = gs_trainer.init_state(scene.gaussians)
        first_iter = 0

    live = None
    if args.live_view:
        live = LiveViewServer(args.live_view)
        logger.echo(f"live view: http://localhost:{live.port}/")

    spatial = scene.cameras_extent
    rng = random.Random(0)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    sh_degree = 0  # raised every 1000 iters up to max (oneupSHdegree)
    stack = []
    profiler = None
    t_start = time.time()
    for iteration in range(first_iter + 1, cfg.iterations + 1):
        if not stack:
            stack = list(scene.train_cameras())
            rng.shuffle(stack)
        cam = stack.pop()
        if args.profile_dir and iteration == PROFILE_FROM:
            profiler = telemetry.start_profile(dev)
        if profiler is not None and iteration == PROFILE_TO:
            _stop_profiler(profiler, args.profile_dir, iteration - 1, logger)
            profiler = None
        if iteration % 1000 == 0:
            sh_degree = min(sh_degree + 1, args.sh_degree)
        state, metrics = gs_trainer.train_step(
            state, RenderCamera.from_camera(cam, dev), _image(cam, dev), bg,
            cfg, spatial_lr_scale=spatial, sh_degree=sh_degree)
        state, info = gs_trainer.maybe_densify(state, generator, cfg,
                                               spatial, iteration)
        state = gs_trainer.grow_if_needed(state, info)

        if live is not None and iteration % args.live_interval == 0:
            _publish(live, cam, state, bg, sh_degree, spatial, dev)
        if iteration % args.log_interval == 0:
            logger.log(iteration, loss=metrics.loss, l1=metrics.l1,
                       points=int(metrics.num_live),
                       capacity=state.params.capacity, pairs=metrics.pairs,
                       nonfinite_grads=int(metrics.nonfinite_grads),
                       it_per_s=args.log_interval / max(
                           time.time() - t_start, 1e-9), **(info or {}))
            t_start = time.time()
        if iteration in args.test_iterations:
            _report(scene, state, bg, sh_degree, iteration, logger, dev)
        if iteration in args.save_iterations:
            path = scene.save(state.params, iteration)
            logger.echo(f"[ITER {iteration}] saved {path}")
        if iteration in args.checkpoint_iterations:
            p = os.path.join(model_path, f"chkpnt{iteration}.npz")
            ckpt_mod.save_train_state(p, state)
            logger.echo(f"[ITER {iteration}] checkpoint {p}")
    if profiler is not None:
        _stop_profiler(profiler, args.profile_dir, cfg.iterations, logger)
    if live is not None:
        live.close()
    logger.close()


def live_camera(cam, pose: dict, spatial: float):
    """The camera the live view asks for: an orbit pose (yaw, pitch in
    degrees; radius in units of the scene's extent) looking at the origin,
    with ``cam``'s intrinsics (the JAX CLI's ``train_gs.py:100-118``)."""
    yaw = math.radians(pose.get("yaw", 0.0))
    pitch = math.radians(pose.get("pitch", 0.0))
    radius = pose.get("radius", 1.0) * spatial
    c = np.array([radius * math.cos(pitch) * math.sin(yaw),
                  radius * math.sin(pitch),
                  -radius * math.cos(pitch) * math.cos(yaw)])
    z = -c / (np.linalg.norm(c) + 1e-9)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x = x / (np.linalg.norm(x) + 1e-9)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, c
    return retarget(cam, c2w, inpainted=False)


def _publish(live, cam, state, bg, sh_degree, spatial, dev):
    """Render the requested pose (the current camera when none was
    posted) and publish it; the one host sync of a live-view iteration."""
    pose = live.requested_pose()
    view = live_camera(cam, pose, spatial) if pose else cam
    with torch.no_grad():
        out = render(state.params, RenderCamera.from_camera(view, dev), bg,
                     sh_degree=sh_degree, device=dev)
    live.publish(out.rgb.cpu().numpy())


def _stop_profiler(prof, profile_dir, last, logger):
    path = telemetry.write_profile(prof, profile_dir)
    logger.echo(f"profiler trace and spans of iterations {PROFILE_FROM}-"
                f"{last} -> {path}, spans.json")


def _report(scene, state, bg, sh_degree, iteration, logger, dev):
    for split, cams in (("test", scene.test_cameras()),
                        ("train", scene.train_cameras()[:5])):
        if not cams:
            continue
        psnrs, l1s = [], []
        for cam in cams:
            with torch.no_grad():
                out = render(state.params, RenderCamera.from_camera(cam, dev),
                             bg, sh_degree=sh_degree, device=dev)
            pred = torch.clamp(out.rgb, 0, 1)
            gt = _image(cam, dev)
            l1s.append(float(loss_utils.l1_loss(pred, gt)))
            psnrs.append(float(loss_utils.psnr(
                pred.permute(2, 0, 1)[None], gt.permute(2, 0, 1)[None])
                .reshape(-1)[0]))
        logger.log(iteration, split=split, psnr=np.mean(psnrs),
                   eval_l1=np.mean(l1s))
        logger.echo(f"[ITER {iteration}] {split}: "
                    f"L1 {np.mean(l1s):.4f} PSNR {np.mean(psnrs):.2f}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(parser)
    common.add_optimization_args(parser)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--capacity", type=int, default=None)
    parser.add_argument("--log_interval", type=int, default=100)
    parser.add_argument("--live_view", type=int, default=0,
                        help="serve a browser live view on this port")
    parser.add_argument("--live_interval", type=int, default=50)
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="autograd anomaly detection (slow)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help=f"write a torch.profiler trace of iterations "
                             f"{PROFILE_FROM}-{PROFILE_TO - 1} to this "
                             f"directory")
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    if not args.save_iterations or args.iterations not in args.save_iterations:
        args.save_iterations = list(args.save_iterations) + [args.iterations]
    with torch.autograd.set_detect_anomaly(args.detect_anomaly):
        train(args)


if __name__ == "__main__":
    main()
