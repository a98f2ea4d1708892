"""SDS coarse object geometry — reference ``gs-simp/sds_train.py``.

Port of ``multiview_inpaint_tpu/pipelines/sds_train.py``: seeds
``--n_samples`` gaussians in the insertion box on top of the del
background (``load_sd_ply``) and trains them on the cone-filtered
training views (``sds_cameras``: the ``bds_train`` masks of ``gen_seq``)
with the background-masked photometric loss plus ``--sds_weight`` (1e-6)
times SDS from a Stable-Diffusion-inpainting prior at CFG
``--guidance_scale`` (100), with the stage-2 optimisation preset
(``INPAINT_OPT``) and its densification. Saves
``<model>/point_cloud/iteration_N/point_cloud.ply`` and the JSONL log
``train_log.jsonl``.

The prior comes from ``--sd_ckpt`` (SD-2-inpainting weights: a torch
``.safetensors``/``.ckpt``/``.pth`` state dict, or an npz in the JAX
layout with ``unet2d/`` and ``vae2d/`` leaves) and ``--text_embs`` (npy
[2, L, 1024]: the unconditional and the prompt embedding). ``--no_sds``
trains the background loss alone.

    python -m multiview_inpaint_tpu_torch.pipelines.sds_train \\
        --scene_id <scene>_<case> -s dataset/<scene> \\
        -m output_sds/<scene>_<case> --bg_model output/<scene> \\
        --sd_ckpt sd2_inpaint.ckpt --text_embs embs.npy [--device cuda|cpu]

``--profile_dir DIR`` writes a ``torch.profiler`` chrome trace of
iterations 100-109 (``trace.json``) with the program's spans on
(``telemetry``: ``sds.step`` and inside it ``render``, ``sds.encode``
twice, ``sds.prior``, ``sds.backward``, ``sds.adam``), and
``spans.json`` beside it: their sums per name (``snapshot``) and the
spans one by one (``records``).

The JAX CLI's TPU knobs (``--backend``, ``--max_per_tile``,
``--pair_budget_mult``) and its pair-budget growth are gone, as in the
port's ``train_gs``: the port's pair count is exact. The box samples, the
SDS draws and the densification draws come from torch generators.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from .. import telemetry
from ..diffusion import checkpoint
from ..gs import gaussians as g_mod
from ..gs import obb as obb_mod
from ..gs import scene as scene_mod
from ..gs.scene import Scene, Workspace
from ..models import gs_trainer, sds_trainer
from ..models.gs_trainer import INPAINT_OPT
from ..ops.rasterizer import RenderCamera
from ..utils.device import resolve_device
from ..utils.logging import RunLogger
from . import common

LATENT_SCALE = 0.18215
PROFILE_FROM, PROFILE_TO = 100, 110


def build_guidance(args, device):
    """``SDSGuidance`` on the SD-2-inpainting UNet2D and the 2D VAE (f32,
    on ``device``) with the weights of ``--sd_ckpt``."""
    from ..diffusion.unet2d import UNet2D, UNet2DConfig
    from ..diffusion.vae import AutoencoderKL, VAEConfig

    unet = UNet2D(UNet2DConfig(), device=device)
    vae = AutoencoderKL(VAEConfig(), video_decoder=False, device=device)
    sd = checkpoint.read_state_dict(args.sd_ckpt)
    m1, _ = checkpoint.import_state_dict(unet, sd,
                                         checkpoint.PREFIXES["unet"])
    m2, _ = checkpoint.import_state_dict(vae, sd,
                                         checkpoint.PREFIXES["vae"])
    del sd
    print(f"sd import: unet missing {len(m1)}, vae missing {len(m2)}")
    return make_guidance(unet, vae, args.guidance_scale)


def make_guidance(unet, vae, guidance_scale: float):
    """``SDSGuidance`` on ``unet`` (the eps model) and ``vae`` (images in
    [0, 1] mapped to [-1, 1], the posterior's mode scaled by
    ``LATENT_SCALE``), both set to eval with no gradients kept for their
    weights."""
    from ..guidance.sds import SDSConfig, SDSGuidance

    unet.eval().requires_grad_(False)
    vae.eval().requires_grad_(False)

    def eps_model(x9, t, text_emb):
        return unet(x9, t, text_emb)

    def vae_encode(img01):
        return vae.encode(img01 * 2 - 1).mode() * LATENT_SCALE

    def vae_decode(z):
        return (vae.decode(z / LATENT_SCALE) + 1) / 2

    return SDSGuidance(eps_model, vae_encode, vae_decode,
                       SDSConfig(guidance_scale=guidance_scale))


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
    cams = scene_mod.sds_cameras(scene, box, iteration=args.bg_iteration)
    if not cams:
        raise SystemExit("no SDS cameras (run gen_seq first)")

    guidance = None if args.no_sds else build_guidance(args, dev)
    if guidance is not None:
        text_embs = _tensor(np.load(args.text_embs), dev)
    os.makedirs(args.model_path, exist_ok=True)
    logger = RunLogger(args.model_path)
    cfg = common.optimization_config_from(args)
    state = gs_trainer.init_state(params)
    bg = common.default_background(args.white_background, dev)
    densify_gen = torch.Generator(device=dev).manual_seed(0)
    sds_gen = torch.Generator(device=dev).manual_seed(1)
    rng = random.Random(0)
    stack = []
    profiler = None
    for iteration in range(1, cfg.iterations + 1):
        if not stack:
            stack = list(cams)
            rng.shuffle(stack)
        cam = stack.pop()
        if args.profile_dir and iteration == PROFILE_FROM:
            profiler = telemetry.start_profile(dev)
        if profiler is not None and iteration == PROFILE_TO:
            _stop_profiler(profiler, args.profile_dir, iteration - 1, logger)
            profiler = None
        rcam = RenderCamera.from_camera(cam, dev)
        gt = _tensor(cam.image, dev)
        m = _tensor(cam.mask, dev)
        if guidance is None:
            state, metrics = gs_trainer.train_step(
                state, rcam, gt, bg, cfg,
                spatial_lr_scale=scene.cameras_extent,
                sh_degree=args.sh_degree, mask=m, loss_mode="background")
            extra = {}
        else:
            state, metrics = sds_trainer.sds_train_step(
                state, rcam, gt, m, bg, cfg, guidance, text_embs,
                spatial_lr_scale=scene.cameras_extent,
                sh_degree=args.sh_degree, sds_weight=args.sds_weight,
                generator=sds_gen)
            extra = {"bg": metrics.bg_loss, "sds": metrics.sds_loss}
        state, info = gs_trainer.maybe_densify(state, densify_gen, cfg,
                                               scene.cameras_extent,
                                               iteration)
        state = gs_trainer.grow_if_needed(state, info)
        if iteration % args.log_interval == 0:
            logger.log(iteration, loss=metrics.loss, pairs=metrics.pairs,
                       points=int(state.params.num_live()),
                       capacity=state.params.capacity,
                       nonfinite_grads=int(metrics.nonfinite_grads),
                       **extra, **(info or {}))
        if iteration in args.save_iterations:
            path = os.path.join(args.model_path, "point_cloud",
                                f"iteration_{iteration}",
                                "point_cloud.ply")
            g_mod.save_ply(state.params, path)
            logger.echo(f"[ITER {iteration}] saved {path}")
    if profiler is not None:
        _stop_profiler(profiler, args.profile_dir, cfg.iterations, logger)
    logger.close()


def _stop_profiler(prof, profile_dir, last, logger):
    path = telemetry.write_profile(prof, profile_dir)
    logger.echo(f"profiler trace and spans of iterations {PROFILE_FROM}-"
                f"{last} -> {path}, spans.json")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(parser)
    common.add_optimization_args(parser, INPAINT_OPT)
    common.add_registry_arg(parser)
    parser.add_argument("--scene_id", required=True)
    parser.add_argument("--bg_model", required=True)
    parser.add_argument("--bg_iteration", type=int, default=30000)
    parser.add_argument("--workspace", default=".")
    parser.add_argument("--inpaint_root", default="inpaint",
                        help="inpaint hand-off dir (abs or relative to workspace)")
    parser.add_argument("--n_samples", type=int, default=30000)
    parser.add_argument("--sd_ckpt", default=None)
    parser.add_argument("--text_embs", default=None)
    parser.add_argument("--no_sds", action="store_true")
    parser.add_argument("--sds_weight", type=float, default=1e-6)
    parser.add_argument("--guidance_scale", type=float, default=100.0)
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[5000])
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help=f"write a torch.profiler trace of iterations "
                             f"{PROFILE_FROM}-{PROFILE_TO - 1} to this "
                             f"directory")
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    common.apply_registry(args)
    if not args.no_sds and (not args.sd_ckpt or not args.text_embs):
        raise SystemExit("--sd_ckpt and --text_embs required "
                         "(or pass --no_sds)")
    if args.iterations not in args.save_iterations:
        args.save_iterations = list(args.save_iterations) + [args.iterations]
    train(args)


if __name__ == "__main__":
    main()
