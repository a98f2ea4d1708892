"""Conditioning: embedders and the vector / crossattn / concat router.

Counterpart of ``multiview_inpaint_tpu/diffusion/conditioners.py`` (the
reference's ``sgm/modules/encoders/modules.py`` at the SVD configuration):

- cond_frames_without_noise -> OpenCLIP image tokens => ``crossattn``
  [b, 1, 1024]
- fps_id, motion_bucket_id, cond_aug -> 256-d fourier each, concatenated
  => ``vector`` [b, 768] (the UNet's adm ``y``)
- cond_frames -> VAE-encoded (mode) latents => ``concat`` [b, h/8, w/8, 4]

The unconditional pass zeroes the two conditioning-frame embeddings; the
noise of the ``cond_aug`` augmentation is passed in (``aug_noise``) so
that tests can feed both packages the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .layers import timestep_embedding


@dataclasses.dataclass(frozen=True)
class ConditionerConfig:
    embed_dim: int = 256          # fourier outdim per scalar key
    force_zero_keys: Tuple[str, ...] = ("cond_frames_without_noise",
                                        "cond_frames")
    vector_keys: Tuple[str, ...] = ("fps_id", "motion_bucket_id",
                                    "cond_aug")


def fourier_scalar_embed(value: torch.Tensor, outdim: int) -> torch.Tensor:
    """ConcatTimestepEmbedderND: [b] or [b, d] scalars -> [b, d*outdim]."""
    emb = timestep_embedding(value.reshape(-1), outdim)
    return emb.reshape(value.shape[0], -1)


class Conditioner:
    """Closes over the frozen encoders: ``clip_embed(frames [b,H,W,3]) ->
    [b, D]`` and ``vae_encode_mode(frames [b,H,W,3]) -> [b, h, w, 4]``."""

    def __init__(self, clip_embed, vae_encode_mode,
                 cfg: ConditionerConfig = ConditionerConfig()):
        self.clip_embed = clip_embed
        self.vae_encode_mode = vae_encode_mode
        self.cfg = cfg

    def __call__(self, batch: Dict, force_zero: bool = False,
                 aug_noise: Optional[torch.Tensor] = None) -> Dict:
        """batch: cond_frames_without_noise [b,H,W,3], cond_frames
        [b,H,W,3], fps_id [b], motion_bucket_id [b], cond_aug [b].
        ``aug_noise`` (a standard normal of cond_frames' shape) adds
        ``cond_aug * aug_noise`` to the frames the VAE encodes. Returns
        {vector, crossattn, concat}."""
        crossattn = self.clip_embed(batch["cond_frames_without_noise"])[
            :, None, :]
        embs = [fourier_scalar_embed(batch[k].reshape(-1, 1),
                                     self.cfg.embed_dim)
                for k in self.cfg.vector_keys]
        rows = max(e.shape[0] for e in embs)
        vec = torch.cat([e.expand(rows, e.shape[1]) for e in embs], dim=-1)
        frames = batch["cond_frames"]
        if aug_noise is not None:
            aug = batch["cond_aug"].reshape((-1,) + (1,) * (frames.ndim - 1))
            frames = frames + aug * aug_noise
        concat = self.vae_encode_mode(frames)
        if force_zero:
            crossattn = torch.zeros_like(crossattn)
            concat = torch.zeros_like(concat)
        return {"vector": vec, "crossattn": crossattn, "concat": concat}


def repeat_cond_per_frame(cond: Dict, t: int,
                          keys=("crossattn", "concat")) -> Dict:
    """[b, ...] -> [(b t), ...] for the time-in-batch layout; leaves
    already per frame (leading dim == t) stay as they are."""
    out = dict(cond)
    for k in keys:
        if k in out and out[k].shape[0] != t:
            out[k] = torch.repeat_interleave(out[k], t, dim=0)
    return out
