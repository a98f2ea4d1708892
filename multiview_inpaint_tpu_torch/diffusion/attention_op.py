"""The one attention op of the diffusion stack.

Counterpart of ``multiview_inpaint_tpu/diffusion/attention_op.py``, with
the JAX op's routing and one rule more: long self-attention (``tq == tk``,
T >= 768, T a multiple of 256, head dim <= 128 and a multiple of 16, the
kernel's tensor-core step, which the JAX op does not ask) on a CUDA tensor
runs the flash-attention kernel K4 (``flash_attention.flash_attention``);
every other shape (the temporal blocks' 14 frames, cross-attention to the
one CLIP token, the ds4 and middle spatial blocks) and every CPU tensor
takes K4's plain version (``flash_attention.flash_attention_ref``): f32
logits and softmax, p cast to the working type, p.v in that type, as
``jax.nn.dot_product_attention`` computes it. The plain math materialises
the ``[B, H, T, T]`` f32 logits (5.3 GB per ds1 layer of the SVD step),
which is why the long shapes never take it on the card. The port calls no
library attention (``scaled_dot_product_attention``,
``nn.MultiheadAttention``) anywhere.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_attention_ref

FLASH_MIN_LEN = 768


def routes_to_flash(tq: int, tk: int, head_dim: int) -> bool:
    """Whether a self-attention shape goes to K4 (on a CUDA tensor)."""
    return (tq == tk and tq >= FLASH_MIN_LEN and tq % 256 == 0
            and head_dim <= 128 and head_dim % 16 == 0)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int, scale: float | None = None) -> torch.Tensor:
    """Multi-head attention over packed ``[B, T, H*D]`` tensors.

    q: [B, Tq, H*D]; k/v: [B, Tk, H*D]. Returns [B, Tq, H*D].
    """
    tq, tk = q.shape[1], k.shape[1]
    d = q.shape[2] // heads
    dt = torch.promote_types(q.dtype, k.dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    sm = d ** -0.5 if scale is None else scale
    if q.is_cuda and routes_to_flash(tq, tk, d):
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), heads, sm)
    return flash_attention_ref(q, k, v, heads, sm)
