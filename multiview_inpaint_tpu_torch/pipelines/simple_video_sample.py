"""Plain SVD image-to-video sampling: the reference's
``scripts/sampling/simple_video_sample.py`` / demo apps.

    python -m multiview_inpaint_tpu_torch.pipelines.simple_video_sample \\
        --image input.png [--base_ckpt svd.npz|svd.safetensors] \\
        [--out out_dir] [--safety_heads heads.npz] \\
        [--device cuda|cpu] [--tiny_model]

Port of ``multiview_inpaint_tpu/pipelines/simple_video_sample.py``: one
conditioning image, the standard SVD conditioning (CLIP tokens, VAE
latents of the image with ``--cond_aug`` noise, the fps / motion fourier
vector), the uncontrolled VideoUNet (no ControlNet; its long
self-attention through the flash-attention kernel on CUDA) under the
per-frame CFG 1.0 -> 2.5 on the uc|c batch, 25 Euler-EDM steps, the
temporal VideoDecoder; frames as PNGs and a GIF (``pipelines/vis``).
With ``--safety_heads`` each frame's CLIP image embedding is scored by
the nsfw / watermark probes and a frame above ``--safety_threshold`` is
blurred (``diffusion/safety``).

Precision: as in the JAX CLI, whose denoiser applies the UNet to f32
latents with the ``--param_dtype`` weights, the UNet computes in f32 on
weights rounded through ``--param_dtype``; ``--compute_dtype`` has no
effect here. Random numbers (the conditioning augmentation's noise, the
initial noise) come from a ``torch.Generator`` seeded with ``--seed``.

Split into ``load_model`` (the engine and its checkpoint, expensive) and
``sample_clip`` (one clip) so that a long-lived caller, the browser demo
``pipelines/demo_app.py``, loads the weights once.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from ..diffusion import checkpoint as ckpt
from ..diffusion import edm, samplers
from ..diffusion.conditioners import repeat_cond_per_frame
from ..diffusion.engine import EngineConfig, init_engine
from ..diffusion.guiders import LinearPredictionGuider
from ..gs import scene_io
from ..utils.device import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", required=True)
    p.add_argument("--out", default="video_out")
    p.add_argument("--base_ckpt", default=None)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--num_steps", type=int, default=25)
    p.add_argument("--size", type=int, nargs=2, default=[512, 384])
    p.add_argument("--fps_id", type=float, default=6)
    p.add_argument("--motion_bucket_id", type=float, default=127)
    p.add_argument("--cond_aug", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--param_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="weight storage type of the full-size UNet, "
                        "ControlNet and CLIP (the VAE stays float32); the "
                        "UNet computes in float32 on these values")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="no effect on this CLI: its UNet computes in "
                        "float32, as the JAX CLI's; kept so that JAX "
                        "command lines parse")
    p.add_argument("--tiny_model", action="store_true")
    p.add_argument("--safety_heads", default=None,
                   help="npz with 'nsfw'/'watermark' probe rows "
                        "([D+1] weights+bias over CLIP image "
                        "embeddings); frames above threshold are "
                        "blurred (reference DeepFloydDataFiltering in "
                        "simple_video_sample.py)")
    p.add_argument("--safety_threshold", type=float, default=0.5)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def _engine_config(args) -> EngineConfig:
    if args.tiny_model:
        from ..diffusion.clip_vit import TINY_VIT
        from ..diffusion.unet import UNetConfig
        from ..diffusion.vae import VAEConfig
        return EngineConfig(
            unet=UNetConfig(model_channels=32, num_res_blocks=1,
                            attention_resolutions=(1,),
                            channel_mult=(1, 2), num_head_channels=16,
                            context_dim=16),
            vae=VAEConfig(ch=16, ch_mult=(1, 2, 4, 4), num_res_blocks=1),
            vit=dataclasses.replace(TINY_VIT, output_dim=16),
            num_frames=args.num_frames, num_steps=args.num_steps)
    return EngineConfig(num_frames=args.num_frames,
                        num_steps=args.num_steps, compute_dtype="float32")


def load_model(args):
    """The engine, with ``--base_ckpt``'s UNet, VAE and CLIP weights when
    given (random from ``--seed`` otherwise), on ``--device``. Returns
    (engine, config), reusable across ``sample_clip`` calls."""
    dev = resolve_device(args.device)
    cfg = _engine_config(args)
    eng = init_engine(cfg, seed=args.seed, device=dev,
                      param_dtype=(None if args.tiny_model
                                   else args.param_dtype))
    if args.base_ckpt:
        sd = ckpt.read_state_dict(args.base_ckpt)
        sd = {k: v for k, v in sd.items()
              if not k.startswith(ckpt.PREFIXES["controlnet"])}
        for comp, (missing, unexpected) in eng.load_reference_state_dict(
                sd).items():
            print(f"base ckpt {comp}: {len(missing)} missing, "
                  f"{len(unexpected)} unexpected")
    return eng, cfg


def uncontrolled_denoise_fn(eng, cfg):
    """``denoise_fn(x, sigma_vec, cond)`` of the UNet alone (no
    ControlNet) with the v-scaling."""
    def denoise(x, sigmas, cond):
        return edm.denoise(lambda xs, c_noise: eng.apply_unet(
            xs, c_noise, cond), x, sigmas, scaling=cfg.scaling)
    return denoise


@torch.no_grad()
def sample_clip(eng, cfg, args):
    """Condition on ``args.image``, sample one clip of ``cfg.num_frames``
    (the loaded model's) and ``cfg.num_steps``, write frames + GIF into
    ``args.out``."""
    dev = eng.device
    img = torch.from_numpy(scene_io.load_image(
        args.image, (args.size[1], args.size[0])) * 2 - 1).to(dev)
    t = cfg.num_frames
    batch = {
        "cond_frames_without_noise": img[None],
        "cond_frames": img[None],
        "fps_id": torch.tensor([args.fps_id], device=dev),
        "motion_bucket_id": torch.tensor([args.motion_bucket_id],
                                         device=dev),
        "cond_aug": torch.tensor([args.cond_aug], device=dev),
    }
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    conditioner = eng.conditioner()
    aug = torch.randn(batch["cond_frames"].shape, generator=gen, device=dev)
    c = conditioner(batch, aug_noise=aug)
    uc = conditioner(batch, force_zero=True)
    keys = ("crossattn", "concat", "vector")
    c = repeat_cond_per_frame(c, t, keys=keys)
    uc = repeat_cond_per_frame(uc, t, keys=keys)

    guider = LinearPredictionGuider(max_scale=cfg.cfg_max,
                                    min_scale=cfg.cfg_min, num_frames=t,
                                    additional_cond_keys=())
    sigmas = edm.edm_sigmas(cfg.num_steps, cfg.sigma_min, cfg.sigma_max,
                            device=dev)
    sigmas = torch.cat([sigmas, sigmas.new_zeros(1)])
    x = torch.randn((t, args.size[0] // 8, args.size[1] // 8, 4),
                    generator=gen, device=dev)
    z = samplers.euler_edm_sample(uncontrolled_denoise_fn(eng, cfg), x, c,
                                  uc, sigmas, guider=guider,
                                  generator=gen)
    frames = eng.decode_first_stage(z, timesteps=t).cpu().numpy()
    if args.safety_heads:
        from ..diffusion.safety import SafetyFilter, load_heads
        filt = SafetyFilter(
            img_embed=lambda im: eng.clip_embed(torch.as_tensor(
                im, dtype=torch.float32, device=dev)[None])[0].cpu().numpy(),
            heads=load_heads(args.safety_heads),
            nsfw_threshold=args.safety_threshold,
            watermark_threshold=args.safety_threshold)
        flagged = 0
        for i in range(t):
            s = filt.scores(frames[i])
            if (s["nsfw"] > filt.nsfw_threshold
                    or s["watermark"] > filt.watermark_threshold):
                frames[i] = filt(frames[i])
                flagged += 1
        if flagged:
            print(f"safety filter blurred {flagged}/{t} frames")
    os.makedirs(args.out, exist_ok=True)
    for i in range(t):
        scene_io.save_image(os.path.join(args.out, f"{i:02d}.png"),
                            (frames[i] + 1) / 2)
    from .vis import main as vis_main
    vis_main(["--frames_dir", args.out,
              "--out", os.path.join(args.out, "video.gif")])
    print(f"{t} frames -> {args.out}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    eng, cfg = load_model(args)
    sample_clip(eng, cfg, args)


if __name__ == "__main__":
    main()
