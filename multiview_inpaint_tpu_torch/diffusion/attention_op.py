"""The one attention op of the diffusion stack.

Counterpart of ``multiview_inpaint_tpu/diffusion/attention_op.py``, with
the JAX op's routing: long self-attention (``tq == tk``, T >= 768, T a
multiple of 256, head dim <= 128) on a CUDA tensor runs the
flash-attention kernel K4 (``flash_attention.flash_attention``, no
logsumexp written; when an input carries a gradient, K4 saving the
logsumexp with K5 as its backward, the JAX op's ``flash_mha`` custom
VJP). The kernels take head dims in ``flash_attention.HEAD_DIMS``
(multiples of 16, their tensor-core step); any other head dim is
zero-padded per head to the next of them, at the true d^-0.5 scale: zero
q and k columns leave q.k unchanged, and the zero v columns give output
columns that are sliced off. Every other shape (the temporal blocks' 14
frames, cross-attention to the one CLIP token, the ds4 and middle
spatial blocks) and every CPU tensor takes K4's plain version
(``flash_attention.flash_attention_ref``, differentiated by autograd):
f32 logits and softmax, p cast to the working type, p.v in that type,
as ``jax.nn.dot_product_attention`` computes it. The plain math
materialises the ``[B, H, T, T]`` f32 logits (5.3 GB per ds1 layer of
the SVD step), which is why the long shapes never take it on the card.
The port calls no library attention (``scaled_dot_product_attention``,
``nn.MultiheadAttention``) anywhere.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .flash_attention import HEAD_DIMS, flash_attention, flash_attention_ref

FLASH_MIN_LEN = 768


def routes_to_flash(tq: int, tk: int, head_dim: int) -> bool:
    """Whether a self-attention shape goes to K4 (and K5 for its
    gradient) on a CUDA tensor."""
    return (tq == tk and tq >= FLASH_MIN_LEN and tq % 256 == 0
            and head_dim <= HEAD_DIMS[-1])


def flash_padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 heads: int, scale: float) -> torch.Tensor:
    """``flash_attention`` on packed ``[B, T, H*D]`` tensors of any head
    dim up to the kernels' largest: each head zero-padded to the next
    dim in ``HEAD_DIMS`` and the output sliced back (no copy where D is
    one of them). Differentiable through the padding."""
    b, t, hd = q.shape
    d = hd // heads
    dp = next(h for h in HEAD_DIMS if h >= d)
    if dp == d:
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), heads, scale)

    def pad(x):
        return F.pad(x.reshape(b, t, heads, d), (0, dp - d)).reshape(
            b, t, heads * dp)

    out = flash_attention(pad(q), pad(k), pad(v), heads, scale)
    return out.reshape(b, t, heads, dp)[..., :d].reshape(b, t, hd)


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
        return flash_padded(q, k, v, heads, sm)
    return flash_attention_ref(q, k, v, heads, sm)
