"""Autoencoder (VAE) adversarial training losses: the PatchGAN
discriminator, the hinge and vanilla losses, and the LPIPS + NLL + KL
generator objective — counterpart of
``multiview_inpaint_tpu/diffusion/autoencoder_loss.py`` (reference
``sgm/modules/autoencoding/losses/discriminator_loss.py``
GeneralLPIPSWithDiscriminator, ``lpips/model/model.py``
NLayerDiscriminator, ``lpips/vqperceptual.py``).

- ``PatchDiscriminator``: 4x4 convs with padding 1 (stride 2, then 1),
  LeakyReLU 0.2, 1-channel patch logits; norms ``"group"`` (flax's
  GroupNorm: 32 groups, eps 1e-6), ``"batch"`` (flax's BatchNorm: eps
  1e-5, running statistics 0.99 old + 0.01 batch, the batch variance
  biased) or ``None``. NHWC in and out; train or eval mode is the
  module's own (``.train()``/``.eval()``), the JAX ``train`` argument.
- ``generator_loss`` / ``discriminator_loss``: the optimizer_idx 0 / 1
  halves of the reference's forward.

The adaptive weight is taken in reconstruction space, as the JAX package
takes it: the norms of the NLL's and the adversarial term's gradients
with respect to the decoder output (``torch.autograd.grad`` on a detached
leaf of ``recon``), clipped to [0, 1e4] and carrying no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class _FlaxBatchNorm(nn.BatchNorm2d):
    """``flax.linen.BatchNorm``: in training, normalise by the batch's
    mean and biased variance and move the running statistics to 0.99 old
    + 0.01 batch (the biased variance, where torch keeps the unbiased)."""

    def __init__(self, c: int, **factory):
        super().__init__(c, eps=1e-5, momentum=0.01, **factory)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(
                self.momentum * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class PatchDiscriminator(nn.Module):
    """PatchGAN discriminator (pix2pix NLayerDiscriminator): [B, H, W, 3]
    -> [B, H/8 - 2, W/8 - 2, 1] patch logits at ``n_layers`` 3. Module
    names are the JAX tree's (``conv_0`` ... ``conv_n``, ``norm_1`` ...
    ``norm_n``, ``head``)."""

    def __init__(self, ndf: int = 64, n_layers: int = 3,
                 norm: Optional[str] = "group", **factory):
        super().__init__()
        self.n_layers = n_layers
        self.conv_0 = nn.Conv2d(3, ndf, 4, stride=2, padding=1, **factory)
        cin = ndf
        for i in range(1, n_layers + 1):
            nf = min(2 ** i, 8)
            # BatchNorm's affine parameters make the conv bias redundant
            setattr(self, f"conv_{i}", nn.Conv2d(
                cin, ndf * nf, 4, stride=2 if i < n_layers else 1,
                padding=1, bias=norm != "batch", **factory))
            if norm == "batch":
                setattr(self, f"norm_{i}", _FlaxBatchNorm(ndf * nf,
                                                          **factory))
            elif norm == "group":
                setattr(self, f"norm_{i}", nn.GroupNorm(
                    32, ndf * nf, eps=1e-6, **factory))
            cin = ndf * nf
        self.head = nn.Conv2d(cin, 1, 4, stride=1, padding=1, **factory)

    def forward(self, x):
        x = F.leaky_relu(self.conv_0(x.permute(0, 3, 1, 2)), 0.2)
        for i in range(1, self.n_layers + 1):
            x = getattr(self, f"conv_{i}")(x)
            if hasattr(self, f"norm_{i}"):
                x = getattr(self, f"norm_{i}")(x)
            x = F.leaky_relu(x, 0.2)
        return self.head(x).permute(0, 2, 3, 1)


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    """vqperceptual.py:5-9."""
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    """vqperceptual.py:12-17."""
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


@dataclasses.dataclass(frozen=True)
class GANLossConfig:
    """GeneralLPIPSWithDiscriminator's knobs
    (discriminator_loss.py:18-33)."""
    disc_start: int = 0
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_loss: str = "hinge"        # "hinge" | "vanilla"
    learn_logvar: bool = False
    # regularizer-term weights, e.g. (("kl_loss", 1e-6),)
    regularization_weights: Tuple[Tuple[str, float], ...] = ()


def adaptive_weight(nll_grad_norm, g_grad_norm, disc_weight: float):
    """discriminator_loss.py:196-205: clamp(|grad nll| / |grad g|, 0, 1e4)
    * disc_weight, without gradient."""
    w = nll_grad_norm / (g_grad_norm + 1e-4)
    return torch.clamp(w, 0.0, 1e4).detach() * disc_weight


def nll_loss_terms(rec_loss: torch.Tensor, logvar: torch.Tensor,
                   weights=None):
    """discriminator_loss.py:289-300: the heteroscedastic NLL with a
    (possibly learned) scalar log-variance; sums over the batch."""
    b = rec_loss.shape[0]
    nll = rec_loss / torch.exp(logvar) + logvar
    weighted = nll if weights is None else weights * nll
    return torch.sum(nll) / b, torch.sum(weighted) / b


def _fold_time(x):
    """[b, t, H, W, C] videos ride time on the batch axis ((b t) leading,
    the layout of both packages); other inputs pass."""
    if x.ndim == 5:
        return x.reshape((-1,) + tuple(x.shape[2:]))
    return x


def generator_loss(disc_apply: Callable, inputs: torch.Tensor,
                   recon: torch.Tensor, logvar: torch.Tensor,
                   global_step: int, cfg: GANLossConfig,
                   lpips_fn: Optional[Callable] = None,
                   regularization_log: Optional[Dict] = None,
                   weights=None) -> Tuple[torch.Tensor, Dict]:
    """optimizer_idx == 0 (discriminator_loss.py:226-276): the L1 +
    perceptual NLL, the adversarial term with the adaptive balance and
    the weighted regularizer terms (e.g. the posterior's KL).
    Differentiable with respect to ``recon`` (and ``logvar``); the
    discriminator is a frozen critic here (its parameters get no
    gradient unless the caller asks for one). The warm-up gate is
    ``float(global_step >= cfg.disc_start)``."""
    inputs, recon = _fold_time(inputs), _fold_time(recon)

    def rec_terms(r):
        rec = torch.abs(inputs - r)
        if lpips_fn is not None and cfg.perceptual_weight > 0:
            p = lpips_fn(inputs, r)                    # [B]
            rec = rec + cfg.perceptual_weight * p.reshape(
                (-1,) + (1,) * (rec.ndim - 1))
        nll, weighted = nll_loss_terms(rec, logvar, weights)
        return weighted, nll, rec

    def g_term(r):
        return -torch.mean(disc_apply(r))

    weighted_nll, nll, rec = rec_terms(recon)
    g_loss = g_term(recon)
    with torch.enable_grad():
        leaf = recon.detach().requires_grad_(True)
        nll_g, = torch.autograd.grad(rec_terms(leaf)[0], leaf)
        g_g, = torch.autograd.grad(g_term(leaf), leaf)
    d_weight = adaptive_weight(torch.linalg.vector_norm(nll_g),
                               torch.linalg.vector_norm(g_g),
                               cfg.disc_weight)
    gate = float(global_step >= cfg.disc_start)
    loss = weighted_nll + gate * d_weight * cfg.disc_factor * g_loss

    log = {"loss/nll": nll, "loss/rec": torch.mean(rec),
           "loss/g": g_loss, "scalars/d_weight": d_weight,
           "scalars/logvar": torch.as_tensor(logvar).detach().clone()}
    for k, w in cfg.regularization_weights:
        term = (regularization_log or {}).get(k)
        if term is not None:
            loss = loss + w * torch.mean(term)
            log[k] = torch.mean(term)
    log["loss/total"] = loss
    return loss, log


def discriminator_loss(disc_apply: Callable, inputs: torch.Tensor,
                       recon: torch.Tensor, global_step: int,
                       cfg: GANLossConfig) -> Tuple[torch.Tensor, Dict]:
    """optimizer_idx == 1 (discriminator_loss.py:277-287): real and fake
    patch logits of the detached inputs and reconstructions -> the hinge
    or vanilla loss, gated by the warm-up schedule."""
    inputs, recon = _fold_time(inputs), _fold_time(recon)
    logits_real = disc_apply(inputs.detach())
    logits_fake = disc_apply(recon.detach())
    fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    gate = float(global_step >= cfg.disc_start)
    d_loss = gate * cfg.disc_factor * fn(logits_real, logits_fake)
    return d_loss, {"loss/disc": d_loss,
                    "logits/real": torch.mean(logits_real),
                    "logits/fake": torch.mean(logits_fake)}
