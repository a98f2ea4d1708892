"""Train the ControlNet of the multi-view SVD inpainter.

    python -m multiview_inpaint_tpu_torch.pipelines.svd_train \\
        --data_root <dst14_est_forward60_2k> --logdir logs/simp1 \\
        [--epochs 50] [--lr 1e-4] [--batch_size N] [--ema] \\
        [--accumulate 1] [--schedule constant|linear|warmup_cosine] \\
        [--warp_loss] [--mask_shrink_k 0.4] [--pose_cond] \\
        [--device cuda|cpu] [--tiny_model]
    torchrun --nproc_per_node N -m multiview_inpaint_tpu_torch.pipelines.\\
        svd_train --data_root <root> --devices N --batch_size B ...

Port of ``multiview_inpaint_tpu/pipelines/svd_train.py``:
ControlNet-only parameters (plus the UNet's label embedding with
``--train_label_emb``), the InpaintDiffusionLoss with one sigma per video,
B videos per step in one forward, Adam as optax computes it with the
constant / linear / warmup-cosine schedules and gradient accumulation, an
optional EMA (the reference's LitEma), ControlNet-only checkpoints
(``<logdir>/checkpoints/epoch=NNNNNN.npz``, the EMA when ``--ema``; the
JAX npz layout, uncompressed, which both packages load), a crash
checkpoint ``last.npz`` and an on-demand one on SIGUSR1 (``melk.npz``),
and the JSONL log
``svd_train_log.jsonl``. On CUDA the long self-attention runs the
flash-attention kernels forward (K4) and backward (K5).

``--warp_loss`` trains on ``WarpSVDForwardDataset`` scenes (depth,
poses.npy, metadata K) with the warp-consistency term; ``--mask_shrink_k``
turns on the mask-shrink augmentation; ``--pose_cond`` adds the
azimuth/polar/radius fourier embeddings to the vector cond.

Random numbers come from ``torch.Generator``s seeded from ``--seed`` (the
JAX CLI derives the same roles from one key): the VAE posterior's and the
conditioning augmentation's noise per batch slot, and the sigmas and noise
of the loss. ``--wandb`` mirrors the JSONL rows to a wandb run where the
package can be imported (``utils.logging``).

Every step goes through ``parallel.svd_data_parallel.make_dp_train_step``.
Under torchrun each rank trains on one card (``mesh.init_from_env``): it
encodes its B / w slots of each batch (``--batch_size`` must divide by the
world size), draws the whole batch's sigmas and noise and keeps its rows,
and the gradients are averaged over the ranks, so a run at world size w
trains the steps of a run at world size 1. ``--devices N`` above the world
size is capped to it, as the JAX CLI caps it to its device count; below
it, it is refused (torchrun starts exactly the ranks asked for). Rank 0
writes the checkpoints, the log and the image grids; the final EMA
evaluation averages its losses over the ranks. Without torchrun the run is
one process on one card, whatever ``--devices`` says.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time

import numpy as np
import torch

from ..data.svd_dataset import (EstSVDForwardDataset,
                                WarpSVDForwardDataset, epoch_iterator)
from ..diffusion import checkpoint as ckpt
from ..diffusion.engine import EngineConfig, init_engine
from ..gs import scene_io
from ..parallel import mesh
from ..parallel.svd_data_parallel import (apply_trainable, batch_draws,
                                          build_optimizer, flatten_videos,
                                          make_dp_train_step,
                                          replicate_state, trainable_params)
from ..utils.logging import RunLogger

POSE_KEYS = ("polars_rad", "azimuths_rad", "rad")


def _engine_config(args) -> EngineConfig:
    vector_keys = ("fps_id", "motion_bucket_id", "cond_aug")
    if getattr(args, "pose_cond", False):
        vector_keys = vector_keys + POSE_KEYS
    adm = 256 * len(vector_keys)
    hint_channels = 3 if getattr(args, "warp_loss", False) else 7
    from ..diffusion.unet import UNetConfig
    if args.tiny_model:
        import dataclasses

        from ..diffusion.clip_vit import TINY_VIT
        from ..diffusion.vae import VAEConfig
        return EngineConfig(
            unet=UNetConfig(model_channels=32, num_res_blocks=1,
                            attention_resolutions=(1,),
                            channel_mult=(1, 2), num_head_channels=16,
                            context_dim=16, adm_in_channels=adm,
                            out_zero_init=False),
            vae=VAEConfig(ch=16, ch_mult=(1, 2, 4, 4), num_res_blocks=1),
            vit=dataclasses.replace(TINY_VIT, output_dim=16),
            num_frames=args.num_frames, vector_keys=vector_keys,
            hint_channels=hint_channels)
    return EngineConfig(num_frames=args.num_frames,
                        compute_dtype=args.compute_dtype,
                        remat={"none": False, "all": "all",
                               "attn": "attn"}[args.remat],
                        unet=UNetConfig(adm_in_channels=adm),
                        vector_keys=vector_keys,
                        hint_channels=hint_channels)


def _load_base(eng, path: str) -> None:
    """UNet, VAE and CLIP weights (npz in the JAX layout, safetensors or
    a torch state dict), then the ControlNet trunk from the UNet."""
    sd = {k: v for k, v in ckpt.read_state_dict(path).items()
          if not k.startswith(ckpt.PREFIXES["controlnet"])}
    for comp, (missing, unexpected) in eng.load_reference_state_dict(
            sd).items():
        print(f"base ckpt {comp}: {len(missing)} missing, {len(unexpected)} "
              f"unexpected")
    eng.init_controlnet_from_unet()


def _trainable_to_jax(tree, clip_heads):
    """A trainable set (reference torch keys) in the JAX checkpoint layout:
    the ControlNet tree alone, or ``controlnet/...`` beside
    ``label_emb/...`` when the label embedding trains too."""
    cn = ckpt.state_dict_to_jax(tree, "controlnet", clip_heads)
    if not any(k.startswith(ckpt.PREFIXES["unet"]) for k in tree):
        return cn
    out = {"controlnet/" + k: v for k, v in cn.items()}
    out.update({"label_emb/" + k: v for k, v in ckpt.state_dict_to_jax(
        tree, "unet", clip_heads).items()})
    return out


def _load_resume(eng, path: str) -> None:
    flat = ckpt.load_params(path)
    if any(k.startswith("controlnet/") for k in flat):
        label = {k[len("label_emb/"):]: v for k, v in flat.items()
                 if k.startswith("label_emb/")}
        flat = {k[len("controlnet/"):]: v for k, v in flat.items()
                if k.startswith("controlnet/")}
        eng.load_reference_state_dict(ckpt.state_dict_from_jax(label,
                                                                "unet"))
    report = eng.load_reference_state_dict(
        ckpt.state_dict_from_jax(flat, "controlnet"))
    missing, unexpected = report["controlnet"]
    print(f"resume: {len(missing)} missing, {len(unexpected)} unexpected")


def _dataset(args):
    if args.warp_loss:
        return WarpSVDForwardDataset(
            args.data_root, size=args.size, num_frames=args.num_frames,
            cond_aug=args.cond_aug, train=True,
            mask_shrink_k=args.mask_shrink_k or 0.4)
    return EstSVDForwardDataset(
        args.data_root, size=args.size, num_frames=args.num_frames,
        cond_aug=args.cond_aug, mask_shrink_k=args.mask_shrink_k,
        pose_cond=args.pose_cond)


class _Quiet:
    """The logger of ranks other than 0: they write nothing."""

    def log(self, *a, **kw):
        pass

    def echo(self, msg):
        pass

    def close(self):
        pass


def _world(args) -> int:
    """The data-parallel world: torchrun's ranks, ``--devices`` capped to
    them and refused below them."""
    w = mesh.world()
    if args.devices is not None and args.devices < w:
        raise ValueError(f"--devices {args.devices} is below the world size "
                         f"{w}: start {args.devices} ranks instead")
    if args.batch_size % w:
        raise ValueError(f"--batch_size {args.batch_size} does not divide "
                         f"by the world size {w}")
    return w


def train(args):
    dev = mesh.init_from_env(args.device)
    world, rank = _world(args), mesh.rank()
    cfg = _engine_config(args)
    eng = init_engine(cfg, seed=args.seed, device=dev,
                      param_dtype=None if args.tiny_model
                      else args.param_dtype)
    if args.base_ckpt:
        _load_base(eng, args.base_ckpt)
    if args.resume:
        _load_resume(eng, args.resume)
    replicate_state(eng)

    ds = _dataset(args)
    steps_per_epoch = max(1, len(ds) // args.batch_size)
    optimizer = build_optimizer(args.lr, args.schedule, args.warmup_steps,
                                steps_per_epoch * args.epochs,
                                args.accumulate)
    params = trainable_params(eng, args.train_label_emb)
    opt_state = optimizer.init(params)
    ema = {k: p.detach().clone() for k, p in params.items()}
    step_fn = make_dp_train_step(
        eng, optimizer, params, ema_decay=args.ema_decay if args.ema else None)

    os.makedirs(args.logdir, exist_ok=True)
    logger = (RunLogger(args.logdir, "svd_train",
                        backend="wandb" if args.wandb else "jsonl",
                        wandb_project=args.wandb_project, config=vars(args))
              if rank == 0 else _Quiet())
    heads = cfg.vit.heads

    def save(tag):
        if rank != 0:
            return
        path = os.path.join(args.logdir, "checkpoints", f"{tag}.npz")
        t0 = time.perf_counter()
        ckpt.save_params(path, _trainable_to_jax(
            ema if args.ema else params, heads))
        logger.echo(f"saved {path} in {time.perf_counter() - t0:.2f} s")
        if args.keep_last and tag.startswith("epoch="):
            d = os.path.dirname(path)
            kept = sorted(f for f in os.listdir(d)
                          if f.startswith("epoch=") and f.endswith(".npz"))
            for old in kept[:-args.keep_last]:
                os.remove(os.path.join(d, old))
                logger.echo(f"rotated out {old}")

    signal.signal(signal.SIGUSR1, lambda *_: save("melk"))

    t, h8, w8 = args.num_frames, args.size[0] // 8, args.size[1] // 8
    slots = args.batch_size // world

    def make_batch(items):
        """Latents (a posterior sample) and per-frame conditioning of this
        rank's videos, stacked to ``[B / w, T, ...]``; slot i of the batch
        draws its noise from the generator seeded (seed, i), as the JAX CLI
        folds i into its key."""
        lat, conds = [], []
        mine = list(enumerate(items))[rank * slots:(rank + 1) * slots]
        for i, (_, b) in mine:
            bt = {k: torch.from_numpy(np.asarray(v)).to(dev)
                  for k, v in b.items() if k != "num_video_frames"}
            gen = torch.Generator(device=dev).manual_seed(
                args.seed * 1_000_003 + i)
            post = torch.randn((t, h8, w8, 4), generator=gen, device=dev)
            aug = torch.randn(bt["cond_frames"].shape, generator=gen,
                              device=dev)
            lat.append(eng.encode_first_stage(bt["jpg"], noise=post))
            cond = eng.prepare_cond(bt, aug_noise=aug)
            if args.warp_loss:
                cond["hit_map"] = bt["hit_map"]
                cond["uv_ind"] = bt["uv_ind"]
            conds.append(cond)
        return torch.stack(lat), {k: torch.stack([c[k] for c in conds])
                                  for k in conds[0]}

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    gstep = 0
    try:
        for epoch in range(args.epochs):
            t0 = time.time()
            items = []
            for it in epoch_iterator(ds, seed=args.seed + epoch):
                items.append(it)
                if len(items) < args.batch_size:
                    continue
                latents_b, cond_b = make_batch(items)
                items = []
                loss = step_fn(opt_state, ema, latents_b, cond_b,
                               generator=gen)
                gstep += 1
                if args.log_images_every and rank == 0 and \
                        gstep % args.log_images_every == 0:
                    _log_images(eng, latents_b, cond_b, gen, args, gstep)
                if gstep % args.log_interval == 0:
                    logger.log(gstep, epoch=epoch, loss=float(loss),
                               sec_per_step=(time.time() - t0)
                               / args.log_interval)
                    t0 = time.time()
            if (epoch + 1) % args.ckpt_every == 0 or \
                    epoch == args.epochs - 1:
                save(f"epoch={epoch:06d}")
    except Exception:
        save("last")  # crash checkpoint (reference SetupCallback)
        raise
    if args.final_ema_eval and args.ema:
        _final_ema_eval(eng, params, ema, ds, make_batch, args, logger)
    logger.close()


def _final_ema_eval(eng, params, ema, ds, make_batch, args, logger):
    """End-of-run objective on a fixed batch set under the raw trainable
    weights and under the EMA: same data, same draws (each rank its videos
    of the batch, the losses averaged over the ranks)."""
    batches, items = [], []
    for it in epoch_iterator(ds, seed=args.seed + 10_000):
        items.append(it)
        if len(items) == args.batch_size:
            batches.append(make_batch(items))
            items = []
        if len(batches) >= args.final_ema_eval:
            break
    raw = {k: p.detach().clone() for k, p in params.items()}
    dev = next(iter(params.values())).device
    tot = {"raw": 0.0, "ema": 0.0}
    with torch.no_grad():
        for name, values in (("raw", raw), ("ema", ema)):
            apply_trainable(params, values)
            for i, (lb, cb) in enumerate(batches):
                lat, cond, warp = flatten_videos(lb, cb)
                gen = torch.Generator(device=dev).manual_seed(
                    args.seed + 20_000 + i)
                sig, noise = batch_draws(lb, generator=gen)
                loss = eng.loss(lat, cond, warp=warp, sigmas=sig,
                                noise=noise)
                tot[name] += float(mesh.all_reduce_sum(loss) / mesh.world())
    apply_trainable(params, raw)
    n = max(1, len(batches))
    row = {"final_eval_batches": n, "loss_raw": tot["raw"] / n,
           "loss_ema": tot["ema"] / n}
    logger.log(-1, event="final_ema_eval", **row)
    logger.echo("final_ema_eval " + json.dumps(row))


def _log_images(eng, latents_b, cond_b, gen, args, gstep):
    """A sample of the current model on the first video of the batch as a
    4-wide grid under <logdir>/log_img/train (the reference ImageLogger),
    drawn from a copy of ``gen``: as the JAX CLI samples from its step key
    without consuming it, the training draws do not depend on it."""
    from .svd_test import to_grid
    cond = {k: v[0] for k, v in cond_b.items()
            if k not in ("hit_map", "uv_ind")}
    uc = dict(cond, crossattn=torch.zeros_like(cond["crossattn"]),
              concat=torch.zeros_like(cond["concat"]))
    t = args.num_frames
    copy = torch.Generator(device=gen.device).set_state(gen.get_state())
    z = eng.sample(cond, uc, latent_shape=(t,) + tuple(latents_b.shape[2:]),
                   generator=copy)
    frames = eng.decode_first_stage(z, timesteps=t).cpu().numpy()
    scene_io.save_image(os.path.join(args.logdir, "log_img", "train",
                                     f"samples_gs-{gstep:06d}.png"),
                        to_grid(frames))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--logdir", default="logs/run")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=1,
                   help="videos per step (sharded over the ranks; one "
                        "forward of B/w*T frames per rank)")
    p.add_argument("--devices", type=int, default=None,
                   help="cards to train on: torchrun's world size (capped "
                        "to it; fewer is refused)")
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--size", type=int, nargs=2, default=[512, 384])
    p.add_argument("--cond_aug", type=float, default=0.0)
    p.add_argument("--base_ckpt", default=None,
                   help="pretrained SVD weights (.safetensors, torch "
                        ".pth/.ckpt or the JAX npz layout)")
    p.add_argument("--resume", default=None,
                   help="a ControlNet checkpoint of this CLI (npz)")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--train_label_emb", action="store_true",
                   help="also train the UNet label embedding "
                        "(VideoDiffusionEngine variant)")
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--schedule", default="constant",
                   choices=["constant", "linear", "warmup_cosine"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--accumulate", type=int, default=1)
    p.add_argument("--ckpt_every", type=int, default=5)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--remat", choices=("none", "attn", "all"),
                   default="none",
                   help="per-block activation recomputation (reference "
                        "use_checkpoint)")
    p.add_argument("--keep_last", type=int, default=0,
                   help="rotate epoch checkpoints, keeping the newest N "
                        "(0 = keep all)")
    p.add_argument("--final_ema_eval", type=int, default=0,
                   help="with --ema: end-of-run loss on N fixed batches "
                        "under raw vs EMA weights")
    p.add_argument("--log_images_every", type=int, default=0,
                   help="sample + save a train grid every N steps "
                        "(ImageLogger parity; 0 = off)")
    p.add_argument("--wandb", action="store_true",
                   help="mirror metrics to wandb when the package is "
                        "available (reference main.py:676-700 "
                        "WandbLogger); degrades to JSONL otherwise")
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--param_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="storage type of the full-size UNet, ControlNet and "
                        "CLIP weights (the trained ControlNet's master "
                        "weights and Adam moments too; the VAE stays f32)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--tiny_model", action="store_true",
                   help="debug-size model for smoke tests")
    p.add_argument("--warp_loss", action="store_true",
                   help="warp-consistency training over depth+pose "
                        "scenes (InpaintDiffusionLoss2 parity)")
    p.add_argument("--mask_shrink_k", type=float, default=0.0,
                   help="random mask-shrink augmentation strength "
                        "(reference process_mask k_max; 0 = off)")
    p.add_argument("--pose_cond", action="store_true",
                   help="append azimuth/polar/radius fourier embeddings "
                        "to the vector cond (needs poses.npy per scene)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    train(p.parse_args(argv))


if __name__ == "__main__":
    main()
