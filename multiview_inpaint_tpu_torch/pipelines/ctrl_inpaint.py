"""Candidate single-view 2D inpaintings — reference ``ctrl_inpaint.py``.

Port of ``multiview_inpaint_tpu/pipelines/ctrl_inpaint.py``: N candidate
inpaintings of the reference (frame-0) view by an SD-inpainting UNet2D
guided by a depth ControlNet2D, at ``--size``^2; the user curates the best
into ``inpaint/ctrl1/``. Writes ``inpaint/ctrl/<scene_case>/ctrl_<i>.png``.

Weights: ``--sd_ckpt`` (the SD-inpainting UNet and VAE) and
``--ctrl_ckpt`` (the depth ControlNet), torch ``.safetensors``/``.ckpt``/
``.pth`` state dicts in the reference key space (or npz files in the JAX
layout); ``--text_embs`` (npy [2, L, D]: the unconditional and the prompt
embedding). The ControlNet's trunk loads in the 2D UNet's key space (the
JAX CLI's importer maps it through the video key space and leaves the
trunk's ResBlocks at their init). Samplers: ``unipc`` (the reference's
UniPCMultistepScheduler) or ``dpmpp2m``, over the legacy DDPM sigma
ladder, with the eps-parameterised network behind an EDM-style wrapper
and CFG at ``--cfg_scale``.

    python -m multiview_inpaint_tpu_torch.pipelines.ctrl_inpaint \\
        --scene_id <scene>_<case> --n_samples 20 \\
        --sd_ckpt sd15_inpaint.ckpt --ctrl_ckpt control_depth.ckpt \\
        --text_embs embs.npy [--device cuda|cpu]

Each sample's initial noise is ``initial_noise`` from a ``torch.Generator``
seeded by ``--seed`` (tests replace the function to pass JAX's draws).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..diffusion import checkpoint, edm, samplers
from ..diffusion.controlnet2d import ControlNet2D
from ..diffusion.unet2d import UNet2D, UNet2DConfig
from ..diffusion.vae import AutoencoderKL, VAEConfig
from ..gs import scene_io
from ..gs.scene import Workspace
from ..guidance.sds import DDPMSchedule, resize_nearest
from ..utils.device import resolve_device
from . import common

LATENT_SCALE = 0.18215


def initial_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """One sample's standard-normal initial latents."""
    return torch.randn(shape, generator=generator, device=device)


def configs(args):
    """(UNet2DConfig, VAEConfig) at full width, or the debug size of
    ``--tiny``."""
    if args.tiny:
        return (UNet2DConfig(model_channels=32, num_res_blocks=1,
                             attention_resolutions=(1,), channel_mult=(1, 2),
                             num_head_channels=16,
                             context_dim=args.context_dim),
                VAEConfig(ch=16, ch_mult=(1, 2, 4, 4), num_res_blocks=1))
    return UNet2DConfig(context_dim=args.context_dim), VAEConfig()


def load_networks(args, dev):
    """The UNet2D, ControlNet2D and 2D VAE with the checkpoints' weights,
    f32 on ``dev``, in eval mode without gradients."""
    cfg2d, vae_cfg = configs(args)
    unet = UNet2D(cfg2d, device=dev)
    cnet = ControlNet2D(cfg2d, device=dev)
    vae = AutoencoderKL(vae_cfg, video_decoder=False, device=dev)
    sd = checkpoint.read_state_dict(args.sd_ckpt)
    m, _ = checkpoint.import_state_dict(unet, sd,
                                        checkpoint.PREFIXES["unet"])
    print(f"sd unet: {len(m)} missing")
    m, _ = checkpoint.import_state_dict(vae, sd, checkpoint.PREFIXES["vae"])
    print(f"sd vae: {len(m)} missing")
    del sd
    csd = checkpoint.read_state_dict(args.ctrl_ckpt, component="controlnet2d")
    m, _ = checkpoint.import_state_dict(cnet, csd,
                                        checkpoint.PREFIXES["controlnet"])
    print(f"controlnet: {len(m)} missing")
    return tuple(n.eval().requires_grad_(False) for n in (unet, cnet, vae))


@torch.no_grad()
def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene_id", required=True)
    p.add_argument("--workspace", default=".")
    p.add_argument("--inpaint_root", default="inpaint")
    p.add_argument("--sd_ckpt", required=True)
    p.add_argument("--ctrl_ckpt", required=True)
    p.add_argument("--text_embs", required=True)
    p.add_argument("--n_samples", type=int, default=20)
    p.add_argument("--num_steps", type=int, default=30)
    p.add_argument("--cfg_scale", type=float, default=7.5)
    p.add_argument("--ctrl_scale", type=float, default=1.0)
    p.add_argument("--sampler", choices=("unipc", "dpmpp2m"),
                   default="unipc",
                   help="unipc matches the reference's "
                        "UniPCMultistepScheduler (ctrl_inpaint.py:12)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--context_dim", type=int, default=768,
                   help="768 for SD-1.5, 1024 for SD-2")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="debug-size UNet/ControlNet/VAE for smoke tests")
    common.add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    ws = Workspace(args.workspace, args.inpaint_root)
    seq = ws.seq_dir(args.scene_id, "x1", args.iteration)
    depth_dir = ws.depth_dir(args.scene_id, "x1")
    size = (args.size, args.size)

    def image(path, grayscale=False):
        return torch.as_tensor(scene_io.load_image(path, size, grayscale),
                               device=dev)

    img = image(os.path.join(seq, "renders", "00.png"))
    mask = image(os.path.join(seq, "mask", "00.png"), grayscale=True)
    hint = image(os.path.join(depth_dir, "00.png"))[None]
    text_embs = torch.as_tensor(np.load(args.text_embs), device=dev)
    unet, cnet, vae = load_networks(args, dev)

    s = args.size // 8
    latents = vae.encode(img[None] * 2 - 1).mode() * LATENT_SCALE
    mask_l = resize_nearest(mask, (s, s))[None, :, :, None]
    masked = vae.encode((img * (1 - mask[..., None]))[None] * 2 - 1
                        ).mode() * LATENT_SCALE
    acp = DDPMSchedule().alphas_cumprod(dev)
    all_sigmas = torch.sqrt((1 - acp) / acp)

    def denoise_fn(x, sigmas_vec, cond):
        # The eps-parameterised DDPM net behind an EDM-style wrapper.
        b = x.shape[0]
        t_idx = torch.argmin(torch.abs(all_sigmas[None, :]
                                       - sigmas_vec[:, None]), dim=-1)
        c_in = 1.0 / torch.sqrt(sigmas_vec ** 2 + 1.0)
        x9 = torch.cat([x * c_in[:, None, None, None],
                        mask_l.expand(b, -1, -1, -1),
                        masked.expand(b, -1, -1, -1)], dim=-1)
        emb = torch.cat([text_embs[0:1].expand(b // 2, -1, -1),
                         text_embs[1:2].expand(b // 2, -1, -1)], dim=0)
        t = t_idx.float()
        control = cnet(x9, hint.expand(b, -1, -1, -1), t, emb)
        control = [c * args.ctrl_scale for c in control]
        eps_u, eps_c = unet(x9, t, emb, control=control).chunk(2, dim=0)
        eps_g = eps_u + args.cfg_scale * (eps_c - eps_u)
        return x - torch.cat([eps_g, eps_g]) * sigmas_vec[:, None, None, None]

    sigmas = torch.cat([edm.legacy_ddpm_sigmas(args.num_steps, device=dev),
                        torch.zeros(1, device=dev)])
    sample = (samplers.unipc_sample if args.sampler == "unipc"
              else samplers.dpmpp2m_sample)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    out_dir = ws.ctrl_dir(args.scene_id)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(args.n_samples):
        x0 = initial_noise(generator, tuple(latents.shape), dev)
        z = sample(denoise_fn, torch.cat([x0, x0]), {}, None, sigmas)[0:1]
        out = vae.decode(z / LATENT_SCALE)
        path = os.path.join(out_dir, f"ctrl_{i}.png")
        scene_io.save_image(path, ((out[0] + 1) / 2).cpu().numpy())
        print(f"sample {i} -> {path}")


if __name__ == "__main__":
    main()
