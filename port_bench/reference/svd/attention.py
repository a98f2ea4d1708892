"""Plain multi-head attention for the reference networks.

The math of the port's plain attention (``flash_attention.mha_ref``):
logits and softmax in float32, ``p`` cast to the working type, ``p.v`` in
that type. Long self-attention is computed in blocks of query rows so
that the ``[B, H, rows, T]`` logits stay near ``BLOCK_ELEMS`` elements.
"""

from __future__ import annotations

import torch

BLOCK_ELEMS = 1 << 28


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int, scale: float | None = None) -> torch.Tensor:
    """q [B, Tq, H*D], k and v [B, Tk, H*D] -> [B, Tq, H*D]."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    d = hd // heads
    dt = torch.promote_types(q.dtype, k.dtype)
    sm = d ** -0.5 if scale is None else scale
    qh = q.to(dt).reshape(b, tq, heads, d).transpose(1, 2)
    kh = k.to(dt).reshape(b, tk, heads, d).transpose(1, 2)
    vh = v.to(dt).reshape(b, tk, heads, d).transpose(1, 2)
    rows = max(1, BLOCK_ELEMS // max(1, b * heads * tk))
    out = []
    for r0 in range(0, tq, rows):
        s = torch.matmul(qh[:, :, r0:r0 + rows].float(),
                         kh.float().transpose(-1, -2)) * sm
        p = torch.softmax(s, dim=-1).to(dt)
        out.append(torch.matmul(p, vh))
    o = torch.cat(out, dim=2) if len(out) > 1 else out[0]
    return o.transpose(1, 2).reshape(b, tq, hd)
