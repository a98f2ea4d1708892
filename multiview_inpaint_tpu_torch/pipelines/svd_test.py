"""Multi-view SVD inpainting inference: the reference ``test.py`` + log
grids.

    python -m multiview_inpaint_tpu_torch.pipelines.svd_test \\
        --data_root gs [--ctrl_ckpt ctrl.npz|ctrl.pth] \\
        [--base_ckpt svd.npz|svd.safetensors|svd.pth] \\
        [--out gs/inpainted] \\
        [--device cuda|cpu] [--tiny_model]

Port of ``multiview_inpaint_tpu/pipelines/svd_test.py``, plain sampling:
for every (scene, ctrl, mode) item of the gs/ directory contract, encode
the conditioning frame (CLIP tokens, VAE latents, the fourier vector) and
take the 7-channel control hint, run the 25-step Euler-EDM sampler with
the per-frame CFG 1.0 -> 2.5 (the ControlNet-augmented UNet on the uc|c
batch of 28 frames, its long self-attention through the flash-attention
kernel on CUDA), decode with the temporal VideoDecoder, and write the
reference-compatible 4x4 grid (``<logdir>/log_img/test/samples_...png``)
and the frames under ``inpainted/<scene>/<ctrl>/<mode>/NN.png``.

Weights: ``--base_ckpt`` (UNet, VAE, CLIP) and ``--ctrl_ckpt`` (the
ControlNet) read the JAX package's npz layout through
``diffusion.checkpoint.state_dict_from_jax``, and ``.safetensors``,
``.pth`` and ``.ckpt`` files in the reference's torch key space directly;
without them the weights are random from ``--seed``. Random numbers (the
initial noise, the conditioning augmentation's noise) come from a
``torch.Generator`` seeded with ``--seed``. Not offered yet: ``--sampling
blended|inversion``, ``--shard_frames`` and ``--dump_latents``.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from ..data.svd_dataset import GSVideoForwardDataset
from ..diffusion import checkpoint as ckpt
from ..diffusion.engine import EngineConfig, init_engine
from ..gs import scene_io
from ..utils.device import resolve_device


def to_grid(frames: np.ndarray, ncol: int = 4, pad: int = 2) -> np.ndarray:
    """[T, H, W, 3] in [-1,1] -> padded grid image in [0,1] (the
    torchvision make_grid layout divide_test expects)."""
    t, h, w, c = frames.shape
    nrow = math.ceil(t / ncol)
    grid = np.zeros((nrow * (h + pad) + pad, ncol * (w + pad) + pad, c),
                    np.float32)
    for i in range(t):
        r, col = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[y:y + h, x:x + w] = (frames[i] + 1) / 2
    return np.clip(grid, 0, 1)


def _engine_config(args) -> EngineConfig:
    if args.tiny_model:
        import dataclasses

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
                        num_steps=args.num_steps,
                        compute_dtype=args.compute_dtype)


def _report(name, report):
    for comp, (missing, unexpected) in report.items():
        print(f"{name} {comp}: {len(missing)} missing, {len(unexpected)} "
              f"unexpected")


def run(args):
    dev = resolve_device(args.device)
    cfg = _engine_config(args)
    eng = init_engine(cfg, seed=args.seed, device=dev,
                      param_dtype=(None if args.tiny_model
                                   else args.param_dtype))
    if args.base_ckpt:
        sd = ckpt.read_state_dict(args.base_ckpt)
        sd = {k: v for k, v in sd.items()
              if not k.startswith(ckpt.PREFIXES["controlnet"])}
        _report("base ckpt", eng.load_reference_state_dict(sd))
    if args.ctrl_ckpt:
        sd = ckpt.read_state_dict(args.ctrl_ckpt, component="controlnet")
        sd = {k: v for k, v in sd.items()
              if k.startswith(ckpt.PREFIXES["controlnet"])}
        _report("ctrl ckpt", eng.load_reference_state_dict(sd))

    ds = GSVideoForwardDataset(args.data_root, size=args.size,
                               num_frames=args.num_frames,
                               modes=args.modes, iteration=args.iteration)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    grid_dir = os.path.join(args.logdir, "log_img", "test")
    os.makedirs(grid_dir, exist_ok=True)
    t = args.num_frames
    h8, w8 = args.size[0] // 8, args.size[1] // 8
    for index in range(len(ds)):
        t0 = time.perf_counter()
        scene, ctrl, mode = ds.meta(index)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds[index].items() if k != "num_video_frames"}
        aug = torch.randn(batch["cond_frames"].shape, generator=gen,
                          device=dev)
        cond = eng.prepare_cond(batch, aug_noise=aug)
        uc = eng.prepare_cond(batch, unconditional=True)
        uc["control_hint"] = cond["control_hint"]
        z = eng.sample(cond, uc, latent_shape=(t, h8, w8, 4),
                       generator=gen)
        frames = eng.decode_first_stage(z, timesteps=t).cpu().numpy()
        name = f"samples_gs-{index:06d}_e-000000_b-{index:06d}.png"
        scene_io.save_image(os.path.join(grid_dir, name), to_grid(frames))
        ctrl_name = os.path.splitext(ctrl)[0]
        out_dir = os.path.join(args.out or os.path.join(args.data_root,
                                                        "inpainted"),
                               scene, ctrl_name, mode)
        for i in range(t):
            scene_io.save_image(os.path.join(out_dir, f"{i:02d}.png"),
                                (frames[i] + 1) / 2)
        print(f"[{index + 1}/{len(ds)}] {scene}/{ctrl_name}/{mode} -> "
              f"{out_dir} ({time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--logdir", default="logs/test")
    p.add_argument("--out", default=None)
    p.add_argument("--base_ckpt", default=None)
    p.add_argument("--ctrl_ckpt", default=None)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--num_steps", type=int, default=25)
    p.add_argument("--size", type=int, nargs=2, default=[512, 384])
    p.add_argument("--modes", nargs="+", default=["x1", "x2"])
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--param_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="weight storage type of the full-size UNet, "
                        "ControlNet and CLIP (the VAE stays float32)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--tiny_model", action="store_true",
                   help="debug-size model for smoke tests")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    run(p.parse_args(argv))


if __name__ == "__main__":
    main()
