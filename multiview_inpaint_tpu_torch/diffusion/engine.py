"""SVDEngine, the paper's ControlNet-augmented multi-view SVD model.

Counterpart of ``multiview_inpaint_tpu/diffusion/engine.py`` (the
reference's ``models/csvd.py`` SVDEngine) for plain sampling and
ControlNet training: the networks are ``nn.Module``s held by the engine,
not a parameter pytree beside it.

- ``apply_model``: concat [x, cond concat] (4 + 4 channels), run the
  ControlNet on the 7-channel hint, add its 13 residuals (x
  ``control_scales``) into the UNet; both networks in the compute type,
  the output in f32.
- ``denoise_fn``: v-scaling with the EDM c_noise around ``apply_model``.
- ``sample``: 25-step Euler-EDM over the Karras ladder (sigma_max 700)
  with the per-frame LinearPredictionGuider (the uc|c batch of 2 x 14
  frames in one evaluation); ``sample_blended`` (the reference's
  VideoDiffusionEngine2: the background latents renoised and blended in
  at every step) and ``sample_inversion`` (EulerEDMSampler3: DDIM-style
  inversion of the background latents through ``inv_denoise_fn``, the raw
  network output, then blended resampling; both passes through the no-op
  LinearPredictionGuider2, so each evaluation is one batch of 14 frames).
- ``init_engine`` builds every network on the requested device and copies
  the UNet's encoder and middle into the ControlNet trunk
  (``init_controlnet_from_unet``).
- first stage: KL-VAE encode (latents x 0.18215; the posterior's mode, or
  a sample from injected noise) and VideoDecoder decode, always in f32.
- ``loss``: the InpaintDiffusionLoss (one sigma per video, EDM weighting,
  optionally the warp-consistency term) around ``denoise_fn``; every
  network is frozen except what ``svd_data_parallel.trainable_params``
  opens (the ControlNet, plus the UNet's label embedding when asked), so
  autograd keeps only the activations between those weights and the
  loss: the ControlNet trunk, the UNet's middle and decoder (where the
  control residuals enter), and the encoder too when the label embedding
  trains.

Precision: the ControlNet and the UNet's label embedding hold
``param_dtype`` weights (the master weights of training) and are cast to
the compute type per call, as the JAX engine casts all its weights; the
rest of the UNet holds its weights in the compute type, rounded through
the parameter type first (the same values the JAX cast gives). An f32
engine keeps the AlphaBlenders' mix factors in the parameter type, as
JAX computes their sigmoid (``_STORED``). The CLIP
tower stores ``param_dtype`` weights and computes in f32 on the f32
frames; the VAE is f32. ``cfg.remat`` recomputes blocks in the backward
pass (``UNetConfig.remat``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from torch.func import functional_call

from .. import telemetry
from ..utils.device import DEFAULT_DEVICE, resolve_device
from . import edm, losses, samplers
from .checkpoint import PREFIXES
from .clip_vit import CLIPVisionTower, ViTConfig
from .conditioners import (Conditioner, ConditionerConfig,
                           repeat_cond_per_frame)
from .controlnet import ControlNet
from .guiders import LinearPredictionGuider, LinearPredictionGuider2
from .layers import AlphaBlender
from .unet import UNetConfig, VideoUNet
from .vae import AutoencoderKL, VAEConfig

SCALE_FACTOR = 0.18215
# In f32 the JAX engine hands the networks their stored parameters
# (``engine.py:31-36``) and flax promotes per operation, so a layer that
# computes on a parameter alone computes in its stored type: the
# AlphaBlender's sigmoid(mix_factor) of bf16-stored weights is a bf16
# sigmoid. These parameters keep the stored type in an f32 engine.
_STORED = ("mix_factor",)


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
    remat: bool | str = False       # False, "all" (or True), "attn"
    vector_keys: tuple = ("fps_id", "motion_bucket_id", "cond_aug")


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def build_models(cfg: EngineConfig, device=None, param_dtype=torch.float32):
    """(VideoUNet, ControlNet, AutoencoderKL, CLIPVisionTower), their
    parameters created on ``device`` in ``param_dtype``, the VAE in f32.
    The engine's ``remat`` threads into the UNet config (both networks)."""
    net = dict(device=device, dtype=_dtype(param_dtype))
    ucfg = dataclasses.replace(cfg.unet, remat=cfg.remat or cfg.unet.remat)
    return (VideoUNet(ucfg, **net), ControlNet(ucfg, cfg.hint_channels, **net),
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
        # The trunk copies the UNet's param_dtype weights, as the JAX
        # init_engine copies its stored ones; then the frozen UNet but its
        # label embedding goes to the compute type.
        self.init_controlnet_from_unet()
        for name, child in self.unet.named_children():
            if name != "label_emb":
                child.to(self.compute_dtype)
        if self.compute_dtype == torch.float32:
            for m in self.unet.modules():
                if isinstance(m, AlphaBlender) and hasattr(m, "mix_factor"):
                    m.mix_factor.data = m.mix_factor.data.to(
                        _dtype(param_dtype))
        self.requires_grad_(False)   # frozen until trainable_params
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
    def encode_first_stage(self, x: torch.Tensor,
                           noise: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """x [B, H, W, 3] in [-1, 1] -> scaled latents [B, H/8, W/8, 4]:
        the posterior's mode, or with ``noise`` (a standard normal of the
        latents' shape) its sample mean + std * noise."""
        post = self.vae.encode(x.float())
        return SCALE_FACTOR * (post.mode() if noise is None
                               else post.sample(noise.float()))

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor, timesteps: int = 1):
        """Scaled latents -> frames in [-1, 1]: the span
        ``engine.decode``."""
        with telemetry.span("engine.decode"):
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
    def _cast_call(self, module: nn.Module, *args, **kwargs):
        """``module`` with its weights not in the compute type (the
        ``param_dtype`` masters) cast to it for this call, differentiably;
        the module itself when none is. In f32 the AlphaBlenders' mix
        factors stay as stored (``_STORED``)."""
        dt = self.compute_dtype
        cast = {k: p.to(dt) for k, p in module.named_parameters()
                if p.dtype != dt and not (dt == torch.float32
                                          and k.endswith(_STORED))}
        if not cast:
            return module(*args, **kwargs)
        return functional_call(module, cast, args, kwargs)

    def apply_model(self, x: torch.Tensor, t_noise: torch.Tensor,
                    cond: Dict, frame_shard=None) -> torch.Tensor:
        """x [(b t), h, w, 4] scaled latents; cond holds the per-frame
        crossattn / vector / concat and the control hint (image size).
        Differentiable in the trainable weights; sampling calls it under
        ``torch.no_grad``.

        ``frame_shard`` (``parallel.svd_inference_parallel.FrameShard``):
        x, t_noise and cond hold every (b t) row, both networks compute
        this rank's block of rows, and that block is returned.

        One call is one span ``engine.eval`` (in sampling, one guided
        evaluation of the CFG batch)."""
        with telemetry.span("engine.eval"):
            xc, t_noise, ctx, vec, kw = self._inputs(x, t_noise, cond,
                                                     frame_shard)
            hint = cond["control_hint"]
            if frame_shard is not None:
                hint = frame_shard.local(hint)
            control = self._cast_call(
                self.controlnet, xc, hint.to(self.compute_dtype), t_noise,
                ctx, vec, **kw)
            control = [c * self.cfg.control_scales for c in control]
            return self._cast_call(self.unet, xc, t_noise, ctx, vec, **kw,
                                   control=control).float()

    def apply_unet(self, x: torch.Tensor, t_noise: torch.Tensor,
                   cond: Dict) -> torch.Tensor:
        """The UNet alone, no ControlNet (``simple_video_sample``'s
        uncontrolled denoiser), inputs as ``apply_model``'s, output f32."""
        xc, t_noise, ctx, vec, kw = self._inputs(x, t_noise, cond)
        return self._cast_call(self.unet, xc, t_noise, ctx, vec,
                               **kw).float()

    def _inputs(self, x, t_noise, cond, frame_shard=None):
        """The networks' inputs in the compute type: x ++ concat, the
        noise levels, the crossattn and vector conditioning, and the frame
        keywords; with ``frame_shard`` this rank's rows of each, and the
        shard bound to every row's context, noise level and vector."""
        t = self.cfg.num_frames
        dt = self.compute_dtype
        ind = torch.zeros((x.shape[0] // t, t), device=x.device)
        xc = torch.cat([x, cond["concat"]], dim=-1).to(dt)
        ctx, vec = (None if cond.get(k) is None else cond[k].to(dt)
                    for k in ("crossattn", "vector"))
        kw = dict(num_video_frames=t, image_only_indicator=ind)
        if frame_shard is None:
            return xc, t_noise, ctx, vec, kw
        shard = frame_shard.bind(ctx, t_noise, vec)
        kw.update(image_only_indicator=shard.local(ind.reshape(-1))[None],
                  frame_shard=shard)
        return (shard.local(xc), shard.local(t_noise), shard.local(ctx),
                shard.local(vec), kw)

    def denoise_fn(self):
        def denoise(x, sigmas, cond):
            return edm.denoise(lambda xs, c_noise: self.apply_model(
                xs, c_noise, cond), x, sigmas, scaling=self.cfg.scaling)
        return denoise

    def inv_denoise_fn(self):
        def denoise(x, sigmas, cond):
            return edm.raw_net_out(lambda xs, c_noise: self.apply_model(
                xs, c_noise, cond), x, sigmas, scaling=self.cfg.scaling)
        return denoise

    def _ladder(self, num_steps):
        cfg = self.cfg
        sigmas = edm.edm_sigmas(num_steps or cfg.num_steps, cfg.sigma_min,
                                cfg.sigma_max, device=self.device)
        return torch.cat([sigmas, sigmas.new_zeros(1)])

    def _noise(self, shape, noise, generator):
        return (noise.to(self.device, torch.float32) if noise is not None
                else torch.randn(shape, generator=generator,
                                 device=self.device))

    @torch.no_grad()
    def sample(self, cond: Dict, uc: Dict,
               latent_shape: Optional[Tuple[int, ...]] = None,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               num_steps: Optional[int] = None,
               denoise_fn=None) -> torch.Tensor:
        """Euler-EDM from ``noise`` (a standard normal of the latent shape;
        drawn from ``generator`` when not given) to clean latents, through
        ``denoise_fn`` when given (the frame-sharded denoiser of
        ``parallel.svd_inference_parallel``), else ``denoise_fn()``."""
        return samplers.euler_edm_sample(
            denoise_fn or self.denoise_fn(),
            self._noise(latent_shape, noise, generator),
            cond, uc, self._ladder(num_steps), guider=self.guider,
            generator=generator)

    @torch.no_grad()
    def sample_blended(self, cond: Dict, uc: Dict, z: torch.Tensor,
                       mask: torch.Tensor,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       num_steps: Optional[int] = None,
                       renoise=None) -> torch.Tensor:
        """The latent-blending path: Euler-EDM from ``noise`` (or a draw
        of z's shape) with the background latents ``z``, renoised each
        step (``renoise``, one standard normal per step, or drawn from
        ``generator``), kept where ``mask`` is 0."""
        return samplers.euler_edm_sample_blended(
            self.denoise_fn(), self._noise(z.shape, noise, generator), cond,
            uc, self._ladder(num_steps), z, mask, guider=self.guider,
            generator=generator, renoise=renoise)

    @torch.no_grad()
    def sample_inversion(self, cond: Dict, uc: Dict, z: torch.Tensor,
                         mask: torch.Tensor,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         num_steps: Optional[int] = None) -> torch.Tensor:
        """The DDIM-inversion resampling path: z inverted up the ladder,
        then Euler-EDM from ``noise`` (or a draw of z's shape) blended
        with the inverted latents where ``mask`` is 0, both passes
        through LinearPredictionGuider2 (c only, no CFG batch)."""
        cfg = self.cfg
        guider2 = LinearPredictionGuider2(
            max_scale=cfg.cfg_max, min_scale=cfg.cfg_min,
            num_frames=cfg.num_frames, additional_cond_keys=("control_hint",))
        return samplers.euler_edm_sample_inversion(
            self.denoise_fn(), self.inv_denoise_fn(),
            self._noise(z.shape, noise, generator), cond, uc,
            self._ladder(num_steps), z, mask, guider=guider2,
            inv_guider=guider2, generator=generator)

    # --- training --------------------------------------------------------
    def loss(self, latents: torch.Tensor, cond: Dict,
             warp: Optional[Dict] = None,
             sigmas: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Mean InpaintDiffusionLoss of latents ``[(b t), h, w, 4]``: one
        sigma per video (``sigmas`` ``[b]``) and ``noise`` of the latents'
        shape, injected or drawn from ``generator``."""
        return losses.inpaint_diffusion_loss(
            self.denoise_fn(), latents, cond,
            num_video_frames=self.cfg.num_frames, warp=warp, sigmas=sigmas,
            noise=noise, generator=generator).mean()

    @torch.no_grad()
    def prepare_cond(self, batch: Dict, aug_noise=None,
                     unconditional: bool = False) -> Dict:
        """Per-video batch -> per-frame conditioning with the control
        hint: the span ``engine.cond``."""
        with telemetry.span("engine.cond"):
            c = self.conditioner()(batch, force_zero=unconditional,
                                   aug_noise=aug_noise)
            c = repeat_cond_per_frame(c, self.cfg.num_frames,
                                      keys=("crossattn", "concat",
                                            "vector"))
            c["control_hint"] = batch["control_hint"]   # already per frame
            return c


def init_engine(cfg: EngineConfig = EngineConfig(), seed: int = 0,
                device=DEFAULT_DEVICE, param_dtype=None) -> SVDEngine:
    """A randomly initialised engine, every parameter created on
    ``device`` from ``seed`` (the ControlNet trunk copied from the UNet).
    ``param_dtype`` (default f32) is the storage type of the UNet,
    ControlNet and CLIP weights; the VAE stays f32."""
    dev = resolve_device(device)
    cards = ([dev.index if dev.index is not None else
              torch.cuda.current_device()] if dev.type == "cuda" else [])
    with torch.random.fork_rng(devices=cards):
        torch.manual_seed(seed)
        return SVDEngine(cfg, device=dev,
                         param_dtype=param_dtype or torch.float32)
