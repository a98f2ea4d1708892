"""SVDEngine, the paper's ControlNet-augmented multi-view SVD model:
inference.

Counterpart of the inference half of
``multiview_inpaint_tpu/diffusion/engine.py`` (the reference's
``models/csvd.py`` SVDEngine): the networks are ``nn.Module``s held by
the engine, not a parameter pytree beside it.

- ``apply_model``: concat [x, cond concat] (4 + 4 channels), run the
  ControlNet on the 7-channel hint, add its 13 residuals (x
  ``control_scales``) into the UNet; both networks in the compute type,
  the output in f32.
- ``denoise_fn``: v-scaling with the EDM c_noise around ``apply_model``.
- ``sample``: 25-step Euler-EDM over the Karras ladder (sigma_max 700)
  with the per-frame LinearPredictionGuider (the uc|c batch of 2 x 14
  frames in one evaluation).
- ``init_engine`` builds every network on the requested device and copies
  the UNet's encoder and middle into the ControlNet trunk
  (``init_controlnet_from_unet``).
- first stage: KL-VAE encode (latents x 0.18215) and VideoDecoder decode,
  always in f32.

Precision: the UNet and the ControlNet hold their weights in the compute
type, rounded through the parameter type first (the JAX engine stores
``param_dtype`` weights and casts them to the compute type per call); the
CLIP tower stores ``param_dtype`` weights and computes in f32 on the f32
frames; the VAE is f32. Training (``loss``) and the blended/inversion
samplers wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..utils.device import DEFAULT_DEVICE, resolve_device
from . import edm, samplers
from .checkpoint import PREFIXES
from .clip_vit import CLIPVisionTower, ViTConfig
from .conditioners import (Conditioner, ConditionerConfig,
                           repeat_cond_per_frame)
from .controlnet import ControlNet
from .guiders import LinearPredictionGuider
from .unet import UNetConfig, VideoUNet
from .vae import AutoencoderKL, VAEConfig

SCALE_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    vit: ViTConfig = ViTConfig()
    hint_channels: int = 7
    num_frames: int = 14
    num_steps: int = 25
    sigma_max: float = 700.0
    sigma_min: float = 0.002
    cfg_min: float = 1.0
    cfg_max: float = 2.5
    control_scales: float = 1.0
    scaling: str = "v_edm_cnoise"
    compute_dtype: str = "float32"  # "bfloat16" for mixed precision
    vector_keys: tuple = ("fps_id", "motion_bucket_id", "cond_aug")


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def build_models(cfg: EngineConfig, device=None, param_dtype=torch.float32):
    """(VideoUNet, ControlNet, AutoencoderKL, CLIPVisionTower), their
    parameters created on ``device``: the UNet and the ControlNet in
    ``param_dtype`` then cast to the compute type, the VAE in f32, the
    CLIP tower in ``param_dtype``."""
    pd, cd = _dtype(param_dtype), _dtype(cfg.compute_dtype)
    net = dict(device=device, dtype=pd)
    return (VideoUNet(cfg.unet, **net).to(cd),
            ControlNet(cfg.unet, cfg.hint_channels, **net).to(cd),
            AutoencoderKL(cfg.vae, device=device, dtype=torch.float32),
            CLIPVisionTower(cfg.vit, **net))


class SVDEngine(nn.Module):
    """The four networks and the sampling plumbing around them."""

    def __init__(self, cfg: EngineConfig = EngineConfig(), device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = _dtype(cfg.compute_dtype)
        self.unet, self.controlnet, self.vae, self.clip = build_models(
            cfg, device, param_dtype)
        self.requires_grad_(False)   # inference: every network is frozen
        self.guider = LinearPredictionGuider(
            max_scale=cfg.cfg_max, min_scale=cfg.cfg_min,
            num_frames=cfg.num_frames, additional_cond_keys=("control_hint",))

    @property
    def device(self) -> torch.device:
        return self.vae.post_quant_conv.weight.device

    # --- weights ---------------------------------------------------------
    def reference_state_dict(self) -> Dict[str, torch.Tensor]:
        """All weights in the reference's torch key space (``PREFIXES``)."""
        return {PREFIXES[name] + k: v for name in PREFIXES
                for k, v in getattr(self, name).state_dict().items()}

    def load_reference_state_dict(self, sd: Dict[str, torch.Tensor]):
        """Tolerant load of reference-keyed weights (any subset of the
        components): returns ``{component: (missing, unexpected)}`` for
        each component the dict touches; a key whose shape differs counts
        as unexpected and is not loaded."""
        report = {}
        for name, prefix in PREFIXES.items():
            sub = {k[len(prefix):]: v for k, v in sd.items()
                   if k.startswith(prefix)}
            if not sub:
                continue
            module = getattr(self, name)
            own = module.state_dict()
            ok = {k: v for k, v in sub.items()
                  if k in own and tuple(own[k].shape) == tuple(v.shape)}
            module.load_state_dict(ok, strict=False)
            report[name] = ([k for k in own if k not in ok],
                            [k for k in sub if k not in ok])
        return report

    def init_controlnet_from_unet(self) -> None:
        """Copy the UNet's encoder, middle and embeddings into the
        ControlNet trunk (the reference's ``init_from_unet``); the hint
        block and the zero convs keep their own init."""
        unet = self.unet.state_dict()
        trunk = {k: v for k, v in unet.items()
                 if k in self.controlnet.state_dict()}
        self.controlnet.load_state_dict(trunk, strict=False)

    # --- first stage -----------------------------------------------------
    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] in [-1, 1] -> scaled latents [B, H/8, W/8, 4]
        (the posterior's mode)."""
        return SCALE_FACTOR * self.vae.encode(x.float()).mode()

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor, timesteps: int = 1):
        return self.vae.decode(z.float() / SCALE_FACTOR, timesteps)

    @torch.no_grad()
    def clip_embed(self, frames: torch.Tensor) -> torch.Tensor:
        return self.clip(frames.float())

    def conditioner(self) -> Conditioner:
        return Conditioner(
            clip_embed=self.clip_embed,
            vae_encode_mode=lambda f: self.encode_first_stage(f)
            / SCALE_FACTOR,
            cfg=ConditionerConfig(vector_keys=tuple(self.cfg.vector_keys)))

    # --- core denoising path --------------------------------------------
    @torch.no_grad()
    def apply_model(self, x: torch.Tensor, t_noise: torch.Tensor,
                    cond: Dict) -> torch.Tensor:
        """x [(b t), h, w, 4] scaled latents; cond holds the per-frame
        crossattn / vector / concat and the control hint (image size)."""
        cfg = self.cfg
        t = cfg.num_frames
        bt = x.shape[0]
        ind = torch.zeros((bt // t, t), device=x.device)
        dt = self.compute_dtype

        def cast(key):
            v = cond.get(key)
            return None if v is None else v.to(dt)

        xc = torch.cat([x, cond["concat"]], dim=-1).to(dt)
        ctx, vec = cast("crossattn"), cast("vector")
        control = self.controlnet(xc, cond["control_hint"].to(dt), t_noise,
                                  ctx, vec, num_video_frames=t,
                                  image_only_indicator=ind)
        control = [c * cfg.control_scales for c in control]
        out = self.unet(xc, t_noise, ctx, vec, num_video_frames=t,
                        image_only_indicator=ind, control=control)
        return out.float()

    def denoise_fn(self):
        def denoise(x, sigmas, cond):
            return edm.denoise(lambda xs, c_noise: self.apply_model(
                xs, c_noise, cond), x, sigmas, scaling=self.cfg.scaling)
        return denoise

    @torch.no_grad()
    def sample(self, cond: Dict, uc: Dict,
               latent_shape: Optional[Tuple[int, ...]] = None,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               num_steps: Optional[int] = None) -> torch.Tensor:
        """Euler-EDM from ``noise`` (a standard normal of the latent shape;
        drawn from ``generator`` when not given) to clean latents."""
        cfg = self.cfg
        dev = self.device
        sigmas = edm.edm_sigmas(num_steps or cfg.num_steps, cfg.sigma_min,
                                cfg.sigma_max, device=dev)
        sigmas = torch.cat([sigmas, sigmas.new_zeros(1)])
        x = (noise.to(dev, torch.float32) if noise is not None else
             torch.randn(latent_shape, generator=generator, device=dev))
        return samplers.euler_edm_sample(self.denoise_fn(), x, cond, uc,
                                         sigmas, guider=self.guider,
                                         generator=generator)

    @torch.no_grad()
    def prepare_cond(self, batch: Dict, aug_noise=None,
                     unconditional: bool = False) -> Dict:
        """Per-video batch -> per-frame conditioning with the control
        hint."""
        c = self.conditioner()(batch, force_zero=unconditional,
                               aug_noise=aug_noise)
        c = repeat_cond_per_frame(c, self.cfg.num_frames,
                                  keys=("crossattn", "concat", "vector"))
        c["control_hint"] = batch["control_hint"]   # already per frame
        return c


def init_engine(cfg: EngineConfig = EngineConfig(), seed: int = 0,
                device=DEFAULT_DEVICE, param_dtype=None) -> SVDEngine:
    """A randomly initialised engine, every parameter created on
    ``device`` from ``seed`` (the ControlNet trunk then copied from the
    UNet). ``param_dtype`` (default f32) is the storage type of the UNet,
    ControlNet and CLIP weights; the VAE stays f32."""
    dev = resolve_device(device)
    cards = ([dev.index if dev.index is not None else
              torch.cuda.current_device()] if dev.type == "cuda" else [])
    with torch.random.fork_rng(devices=cards):
        torch.manual_seed(seed)
        eng = SVDEngine(cfg, device=dev,
                        param_dtype=param_dtype or torch.float32)
    eng.init_controlnet_from_unet()
    return eng
