"""Finetune the first-stage KL autoencoder with the adversarial loss.

Port of ``multiview_inpaint_tpu/pipelines/vae_finetune.py`` (the sgm
GeneralLPIPSWithDiscriminator objective with its two optimizers). One
step is the generator update (the autoencoder's parameters and the
learned scalar ``logvar``: L1 + optional LPIPS NLL + KL + the
adversarial term with the adaptive balance) and then the discriminator
update (PatchGAN hinge or vanilla loss on the detached reconstruction of
the same step), each with Adam(b1 0.5, b2 0.9, eps 1e-8) as
``optax.adam`` computes it (``parallel/svd_data_parallel.Optimizer``).

    python -m multiview_inpaint_tpu_torch.pipelines.vae_finetune \\
        --data_dir <folder of images> --out_dir <ckpt dir> \\
        [--steps 100] [--resolution 64] [--batch_size 4] \\
        [--lr 4.5e-6] [--disc_start 0] [--kl_weight 1e-6] \\
        [--disc_weight 0.5] [--disc_loss hinge|vanilla] \\
        [--perceptual_weight 0] [--lpips_ckpt vgg.npz] [--tiny] \\
        [--device cuda|cpu]

``--tiny`` shrinks the VAE (ch 32, one level) and the discriminator.
Outputs: ``<out_dir>/vae_params.npz`` and ``disc_params.npz`` under the
JAX trees' key names (the JAX ``load_params`` reads them), and
``train_log.jsonl`` with the JAX CLI's keys at its steps. The initial
weights come from ``--seed`` through PyTorch's generator and the batches
from ``np.random.default_rng(--seed)``; the posterior's sample noise is
drawn by ``posterior_noise`` from a ``torch.Generator`` seeded with
``--seed`` (JAX's ``jax.random`` draws cannot be reproduced; the hook
takes them in tests).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..diffusion import checkpoint as ckpt
from ..diffusion.autoencoder_loss import (GANLossConfig,
                                          PatchDiscriminator,
                                          discriminator_loss,
                                          generator_loss)
from ..diffusion.vae import AutoencoderKL, VAEConfig
from ..parallel.svd_data_parallel import Optimizer
from ..utils.device import resolve_device
from . import common


def _load_images(data_dir, resolution):
    from ..gs import scene_io
    paths = sorted(p for ext in ("png", "jpg", "jpeg")
                   for p in glob.glob(os.path.join(data_dir, f"*.{ext}")))
    if not paths:
        raise FileNotFoundError(f"no images under {data_dir}")
    imgs = [scene_io.load_image(p, resolution=(resolution, resolution))
            for p in paths]
    return np.stack(imgs).astype(np.float32) * 2.0 - 1.0  # [-1, 1]


def build_models(tiny: bool, device=None):
    cfg = (VAEConfig(ch=32, ch_mult=(1,), num_res_blocks=1, z_channels=4)
           if tiny else VAEConfig())
    vae = AutoencoderKL(cfg, video_decoder=False, device=device)
    disc = PatchDiscriminator(ndf=32 if tiny else 64,
                              n_layers=2 if tiny else 3, device=device)
    return vae, disc


def posterior_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """The standard normal draw of one step's posterior sample."""
    return torch.randn(shape, generator=generator, device=generator.device)


class Finetuner:
    """The alternating step over ``vae`` (``video_decoder=False``),
    ``disc`` and a learned ``logvar`` (starting at 0), Adam for each side
    (the discriminator's lr is ``disc_lr`` or ``lr``)."""

    def __init__(self, vae: AutoencoderKL, disc: PatchDiscriminator,
                 cfg: GANLossConfig, lr: float,
                 disc_lr: Optional[float] = None,
                 lpips_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        self.vae, self.disc, self.cfg, self.lpips_fn = vae, disc, cfg, lpips_fn
        self.generator = generator
        dev = next(vae.parameters()).device
        self.logvar = torch.nn.Parameter(torch.zeros((), device=dev))
        self.gen_params = {f"params/{k}": p
                           for k, p in vae.named_parameters()}
        self.gen_params["logvar"] = self.logvar
        self.disc_params = dict(disc.named_parameters())
        self.gen_opt = Optimizer(lr, b1=0.5, b2=0.9)
        self.disc_opt = Optimizer(disc_lr or lr, b1=0.5, b2=0.9)
        self.gen_state = self.gen_opt.init(self.gen_params)
        self.disc_state = self.disc_opt.init(self.disc_params)

    def step(self, x: torch.Tensor, step: int,
             noise: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One generator and one discriminator update on the batch ``x``
        ([B, H, W, 3] in [-1, 1]) with the posterior's ``noise`` (drawn by
        ``posterior_noise`` from ``generator`` when not given); returns
        the log (the generator's terms, then the discriminator's)."""
        post = self.vae.encode(x)
        if noise is None:
            noise = posterior_noise(post.mean.shape, self.generator)
        recon = self.vae.decode(post.sample(noise))
        kl = 0.5 * torch.sum(post.mean ** 2 + torch.exp(post.logvar)
                             - 1.0 - post.logvar,
                             dim=tuple(range(1, post.mean.ndim)))
        loss, g_log = generator_loss(
            self.disc, x, recon, self.logvar, step, self.cfg,
            lpips_fn=self.lpips_fn, regularization_log={"kl_loss": kl})
        grads = dict(zip(self.gen_params, torch.autograd.grad(
            loss, list(self.gen_params.values()))))
        if not self.cfg.learn_logvar:
            grads["logvar"] = torch.zeros_like(grads["logvar"])
        self.gen_opt.step(self.gen_params, grads, self.gen_state)

        d_loss, d_log = discriminator_loss(self.disc, x, recon, step,
                                           self.cfg)
        d_grads = torch.autograd.grad(d_loss,
                                      list(self.disc_params.values()))
        self.disc_opt.step(self.disc_params,
                           dict(zip(self.disc_params, d_grads)),
                           self.disc_state)
        return {k: v.detach() for k, v in {**g_log, **d_log}.items()}

    def vae_params_jax(self) -> Dict[str, np.ndarray]:
        """The autoencoder's parameters under the JAX tree's keys."""
        pre = ckpt.PREFIXES["vae"]
        return ckpt.state_dict_to_jax(
            {pre + k: v for k, v in self.vae.state_dict().items()},
            component="vae2d")

    def disc_params_jax(self) -> Dict[str, np.ndarray]:
        """The discriminator's parameters under the JAX tree's keys."""
        return ckpt.torch_to_flax(dict(self.disc.named_parameters()))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--lr", type=float, default=4.5e-6)
    parser.add_argument("--disc_lr", type=float, default=None)
    parser.add_argument("--disc_start", type=int, default=0)
    parser.add_argument("--disc_weight", type=float, default=0.5)
    parser.add_argument("--disc_loss", default="hinge",
                        choices=["hinge", "vanilla"])
    parser.add_argument("--kl_weight", type=float, default=1e-6)
    parser.add_argument("--perceptual_weight", type=float, default=0.0)
    parser.add_argument("--lpips_ckpt", default=None,
                        help="LPIPS weights npz (external artifact); "
                             "required when --perceptual_weight > 0")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_interval", type=int, default=10)
    parser.add_argument("--tiny", action="store_true")
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    data = torch.from_numpy(_load_images(args.data_dir, args.resolution)
                            ).to(dev)
    cards = [torch.cuda.current_device()] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=cards):
        torch.manual_seed(args.seed)
        vae, disc = build_models(args.tiny, dev)
    cfg = GANLossConfig(
        disc_start=args.disc_start, disc_weight=args.disc_weight,
        disc_loss=args.disc_loss,
        perceptual_weight=args.perceptual_weight,
        learn_logvar=True,
        regularization_weights=(("kl_loss", args.kl_weight),))

    lpips_fn = None
    if args.perceptual_weight > 0:
        from ..metrics.lpips import load_lpips_npz
        lpips_fn = load_lpips_npz(args.lpips_ckpt, dev)

    tuner = Finetuner(vae, disc, cfg, args.lr, args.disc_lr, lpips_fn,
                      torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    log_path = os.path.join(args.out_dir, "train_log.jsonl")
    t0 = time.time()
    with open(log_path, "w") as f:
        for step in range(args.steps):
            idx = rng.integers(0, len(data), args.batch_size)
            log = tuner.step(data[torch.from_numpy(idx).to(dev)], step)
            if step % args.log_interval == 0 or step == args.steps - 1:
                rec = {k: float(v) for k, v in log.items()}
                rec.update(step=step, dt=time.time() - t0)
                f.write(json.dumps(rec) + "\n")
                print(f"step {step}: rec={rec['loss/rec']:.4f} "
                      f"g={rec['loss/g']:.4f} "
                      f"disc={rec['loss/disc']:.4f}", flush=True)

    ckpt.save_params(os.path.join(args.out_dir, "vae_params.npz"),
                     {"params": tuner.vae_params_jax(),
                      "logvar": tuner.logvar})
    ckpt.save_params(os.path.join(args.out_dir, "disc_params.npz"),
                     {"params": tuner.disc_params_jax()})
    print(f"saved -> {args.out_dir}")


if __name__ == "__main__":
    main()
