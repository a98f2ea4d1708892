"""Autoencoder latent regularizers, KL and vector quantization —
counterpart of ``multiview_inpaint_tpu/diffusion/regularizers.py``
(reference ``sgm/modules/autoencoding/regularizers/__init__.py``
DiagonalGaussianRegularizer and ``regularizers/quantize.py``
VectorQuantizer, EmbeddingEMA/EMAVectorQuantizer).

- ``diagonal_gaussian_regularizer``: sample or mode and the summed KL
  (``generator_loss``'s ``kl_loss``); the sample's noise is injected or
  drawn from a ``torch.Generator``.
- ``VectorQuantizer``: nearest code by -2 z.e + |e|^2 (the z-norm term
  does not change the ranking), ties to the first index as ``argmax``
  takes them in both packages; the straight-through estimator, the
  beta-commitment loss, the codebook perplexity.
- ``ema_codebook_update``: the EMA quantizer's cluster-size and
  embedding-sum update, a pure function of an explicit state dict
  (Laplace-smoothed normalisation as in EmbeddingEMA).

Tensors are [..., D] channels-last, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DEFAULT_DEVICE, resolve_device
from .vae import DiagonalGaussian


def diagonal_gaussian_regularizer(z_params: torch.Tensor,
                                  noise: Optional[torch.Tensor] = None,
                                  sample: bool = True,
                                  generator: Optional[torch.Generator] = None
                                  ) -> Tuple[torch.Tensor, Dict]:
    """(mean ++ logvar) channels -> (z, {"kl_loss"}), the KL summed per
    item and averaged over the batch. ``noise`` is the sample's standard
    normal draw (drawn from ``generator`` when not given)."""
    post = DiagonalGaussian(z_params)
    if sample:
        if noise is None:
            noise = torch.randn(post.mean.shape, generator=generator,
                                device=post.mean.device,
                                dtype=post.mean.dtype)
        z = post.sample(noise)
    else:
        z = post.mode()
    kl = 0.5 * torch.sum(post.mean ** 2 + torch.exp(post.logvar) - 1.0
                         - post.logvar,
                         dim=tuple(range(1, post.mean.ndim)))
    return z, {"kl_loss": torch.sum(kl) / kl.shape[0]}


def perplexity(one_hot: torch.Tensor) -> torch.Tensor:
    """exp(entropy) of codebook usage (base.measure_perplexity)."""
    probs = torch.mean(one_hot, dim=0)
    return torch.exp(-torch.sum(probs * torch.log(probs + 1e-10)))


def _nearest_code(flat: torch.Tensor, codebook: torch.Tensor
                  ) -> torch.Tensor:
    """argmin_k |z - e_k|^2 as argmax_k (z.e_k - |e_k|^2 / 2), the first
    index on ties (``jnp.argmax``'s rule and ``torch.argmax``'s)."""
    scores = flat @ codebook.T - 0.5 * torch.sum(codebook ** 2, dim=1)
    return torch.argmax(scores, dim=1)


def _quantize(z, codebook):
    flat = z.reshape(-1, codebook.shape[1])
    idx = _nearest_code(flat, codebook)
    return idx, codebook[idx].reshape(z.shape)


class VectorQuantizer(nn.Module):
    """Nearest-neighbour codebook with the straight-through estimator.
    Input [..., D]; returns (z_q, log) with ``log["vq_loss"]`` the
    codebook + beta commitment terms and ``log["indices"]`` the flat
    code ids. The codebook starts uniform in +-1/n_codes."""

    def __init__(self, n_codes: int = 8192, dim: int = 4,
                 beta: float = 0.25, **factory):
        super().__init__()
        self.beta = beta
        self.codebook = nn.Parameter(torch.empty(n_codes, dim, **factory))
        nn.init.uniform_(self.codebook, -1.0 / n_codes, 1.0 / n_codes)

    def forward(self, z):
        idx, z_q = _quantize(z, self.codebook)
        # codebook pull + commitment (quantize.py:263-265)
        loss = (torch.mean((z.detach() - z_q) ** 2)
                + self.beta * torch.mean((z - z_q.detach()) ** 2))
        z_st = z + (z_q - z).detach()
        one_hot = F.one_hot(idx, self.codebook.shape[0]).to(z.dtype)
        return z_st, {"vq_loss": loss, "indices": idx,
                      "perplexity": perplexity(one_hot)}


def init_ema_codebook(n_codes: int, dim: int,
                      generator: Optional[torch.Generator] = None,
                      device=DEFAULT_DEVICE,
                      codebook: Optional[torch.Tensor] = None) -> Dict:
    """State for ``ema_codebook_update`` (EmbeddingEMA): the codebook (a
    standard normal draw from ``generator`` on ``device``, or ``codebook``
    as given, on its own device), EMA cluster sizes and EMA embedding
    sums."""
    if codebook is None:
        codebook = torch.randn((n_codes, dim), generator=generator,
                               device=resolve_device(device))
    return {"codebook": codebook, "cluster_size": torch.zeros(
        n_codes, device=codebook.device), "embed_avg": codebook.clone()}


def ema_quantize(state: Dict, z: torch.Tensor,
                 beta: float = 0.25) -> Tuple[torch.Tensor, Dict]:
    """Forward through the EMA codebook (EMAVectorQuantizer): the
    straight-through z_q and the beta-commitment loss (the codebook moves
    by ``ema_codebook_update``, not by this gradient)."""
    idx, z_q = _quantize(z, state["codebook"])
    loss = beta * torch.mean((z - z_q.detach()) ** 2)
    z_st = z + (z_q - z).detach()
    one_hot = F.one_hot(idx, state["codebook"].shape[0]).to(z.dtype)
    return z_st, {"vq_loss": loss, "indices": idx,
                  "perplexity": perplexity(one_hot)}


def ema_codebook_update(state: Dict, z: torch.Tensor,
                        decay: float = 0.99, eps: float = 1e-5) -> Dict:
    """One EMA step over a batch of latents (EmbeddingEMA's cluster-size
    and embedding-sum updates and the Laplace-smoothed normalisation);
    returns the new state."""
    n_codes, dim = state["codebook"].shape
    flat = z.reshape(-1, dim)
    one_hot = F.one_hot(_nearest_code(flat, state["codebook"]),
                        n_codes).to(flat.dtype)
    counts = torch.sum(one_hot, dim=0)                 # [K]
    sums = one_hot.T @ flat                            # [K, D]
    cluster = state["cluster_size"] * decay + (1 - decay) * counts
    embed_avg = state["embed_avg"] * decay + (1 - decay) * sums
    n = torch.sum(cluster)
    smoothed = (cluster + eps) / (n + n_codes * eps) * n
    return {"codebook": embed_avg / smoothed[:, None],
            "cluster_size": cluster, "embed_avg": embed_avg}
