"""The plain reference of the ControlNet-augmented multi-view SVD clip.

The networks are frozen copies of the port's plain modules (this folder:
``unet``, ``controlnet``, ``vae``, ``clip_vit`` and their layers), with the
attention of ``attention.py``; the sampling plumbing below follows the
reference's ``svd_test`` for one clip:

- conditioning of c and uc: CLIP image tokens of the conditioning frame,
  the fourier vector of (fps_id, motion_bucket_id, cond_aug), the VAE
  posterior's mode of the (augmented) conditioning frame, both zeroed for
  uc; the control hint per frame;
- 25 Euler-EDM steps over the Karras ladder (sigma 700 -> 0.002), each one
  evaluation of ControlNet + UNet on the uc|c batch of 2 x 14 frames with
  the v-scaling and c_noise of ``edm``, combined per frame by the linear
  guider (scale 1.0 -> 2.5 over the frames);
- the temporal VAE decode of the latents / 0.18215.

Every network computes in ``dtype`` (float32 by default; the caller turns
TF32 off); the VAE always in float32. Weights come in through ``load``,
in the reference checkpoint's key space.
"""

from __future__ import annotations

import torch
from torch import nn

from . import edm
from .clip_vit import CLIPVisionTower, ViTConfig
from .conditioners import fourier_scalar_embed
from .controlnet import ControlNet
from .guiders import LinearPredictionGuider
from .unet import UNetConfig, VideoUNet
from .vae import AutoencoderKL, VAEConfig

SCALE_FACTOR = 0.18215
PREFIXES = {
    "unet": "model.diffusion_model.",
    "controlnet": "control_model.",
    "vae": "first_stage_model.",
    "clip": "conditioner.embedders.0.open_clip.model.visual.",
}
VECTOR_KEYS = ("fps_id", "motion_bucket_id", "cond_aug")


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def configs(cfg: dict):
    """(UNetConfig, VAEConfig, ViTConfig) from a configuration file's
    ``unet``, ``vae`` and ``vit`` groups."""
    return (UNetConfig(**_tuples(cfg["unet"])),
            VAEConfig(**_tuples(cfg["vae"])),
            ViTConfig(**_tuples(cfg["vit"])))


class ReferenceSVD(nn.Module):
    def __init__(self, cfg: dict, device=None, dtype=torch.float32):
        super().__init__()
        ucfg, vcfg, vitcfg = configs(cfg)
        net = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.dtype = dtype
        self.unet = VideoUNet(ucfg, **net)
        self.controlnet = ControlNet(ucfg, cfg["hint_channels"], **net)
        self.vae = AutoencoderKL(vcfg, device=device, dtype=torch.float32)
        self.clip = CLIPVisionTower(vitcfg, **net)
        self.guider = LinearPredictionGuider(
            max_scale=cfg["cfg_max"], min_scale=cfg["cfg_min"],
            num_frames=cfg["num_frames"],
            additional_cond_keys=("control_hint",))

    def load(self, sd: dict) -> None:
        """Strict load of reference-keyed weights into every network."""
        for name, prefix in PREFIXES.items():
            sub = {k[len(prefix):]: v for k, v in sd.items()
                   if k.startswith(prefix)}
            getattr(self, name).load_state_dict(sub, strict=True)

    # --- conditioning ----------------------------------------------------
    @torch.no_grad()
    def cond(self, batch: dict, aug_noise=None, unconditional=False):
        t = self.cfg["num_frames"]
        crossattn = self.clip(batch["cond_frames_without_noise"].float()
                              .to(self.dtype)).float()[:, None, :]
        embs = [fourier_scalar_embed(batch[k].reshape(-1, 1), 256)
                for k in VECTOR_KEYS]
        vec = torch.cat(embs, dim=-1)
        frames = batch["cond_frames"]
        if aug_noise is not None:
            frames = frames + batch["cond_aug"].reshape(-1, 1, 1, 1) \
                * aug_noise
        concat = self.vae.encode(frames.float()).mode()
        if unconditional:
            crossattn = torch.zeros_like(crossattn)
            concat = torch.zeros_like(concat)
        rep = lambda x: torch.repeat_interleave(x, t, dim=0)  # noqa: E731
        return {"crossattn": rep(crossattn), "concat": rep(concat),
                "vector": rep(vec), "control_hint": batch["control_hint"]}

    # --- denoiser --------------------------------------------------------
    def apply_model(self, x, t_noise, cond):
        t = self.cfg["num_frames"]
        dt = self.dtype
        ind = torch.zeros((x.shape[0] // t, t), device=x.device)
        xc = torch.cat([x, cond["concat"]], dim=-1).to(dt)
        ctx, vec = cond["crossattn"].to(dt), cond["vector"].to(dt)
        kw = dict(num_video_frames=t, image_only_indicator=ind)
        control = self.controlnet(xc, cond["control_hint"].to(dt), t_noise,
                                  ctx, vec, **kw)
        control = [c * self.cfg["control_scales"] for c in control]
        return self.unet(xc, t_noise, ctx, vec, **kw,
                         control=control).float()

    def denoise(self, x, sigmas, cond):
        return edm.denoise(lambda xs, c_noise: self.apply_model(
            xs, c_noise, cond), x, sigmas, scaling="v_edm_cnoise")

    @torch.no_grad()
    def sample(self, cond, uc, noise, num_steps: int):
        cfg = self.cfg
        sigmas = edm.edm_sigmas(num_steps, cfg["sigma_min"],
                                cfg["sigma_max"], device=noise.device)
        sigmas = torch.cat([sigmas, sigmas.new_zeros(1)])
        x = noise.float() * torch.sqrt(1.0 + sigmas[0] ** 2)
        for i in range(num_steps):
            s_vec = sigmas[i].expand(x.shape[0])
            gx, gs, gc = self.guider.prepare(x, s_vec, cond, uc)
            denoised = self.guider.combine(self.denoise(gx, gs, gc), s_vec)
            d = (x - denoised) / sigmas[i]
            x = x + (sigmas[i + 1] - sigmas[i]) * d
        return x

    @torch.no_grad()
    def decode(self, z):
        return self.vae.decode(z.float() / SCALE_FACTOR,
                               self.cfg["num_frames"])

    @torch.no_grad()
    def clip_frames(self, inputs: dict, num_steps: int):
        """The decoded frames [T, H, W, 3] of one clip's inputs."""
        batch = inputs["batch"]
        c = self.cond(batch, aug_noise=inputs["aug_noise"])
        uc = self.cond(batch, unconditional=True)
        z = self.sample(c, uc, inputs["noise"], num_steps)
        return self.decode(z)


def weight_spec(cfg: dict) -> list:
    """[(key, shape)] of every weight, in the checkpoint's key space, from
    the reference built on the meta device."""
    with torch.device("meta"):
        ref = ReferenceSVD(cfg, dtype=torch.bfloat16)
    return [(PREFIXES[name] + k, tuple(v.shape)) for name in PREFIXES
            for k, v in getattr(ref, name).state_dict().items()]


def storage_dtype(key: str) -> torch.dtype:
    """The served storage type: the VAE in float32, the rest bfloat16."""
    return (torch.float32 if key.startswith(PREFIXES["vae"])
            else torch.bfloat16)

