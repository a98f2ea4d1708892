"""The flash-attention forward kernel (K4) and its plain version.

Counterpart of ``multiview_inpaint_tpu/diffusion/flash_attention.py``
(``_kernel`` via ``_flash_fwd_impl`` and ``flash_mha``): non-causal,
unmasked multi-head attention with f32 logits, an f32 softmax, p rounded
to the value type before p.v, and an f32 sum. The CUDA source is
``csrc/flash_attn_fwd.cu`` (one block per head and 64-row query tile,
bf16 tensor-core products, the online softmax in registers; its note says
more). f32 inputs are rounded to bf16 as the kernel stages them, so the
f32 path keeps bf16 operands with f32 sums, as the TPU kernel's products
do; its output differs from the f32 plain version by bf16 rounding of q,
k, v and p (a few 1e-3 at unit-normal inputs).

The backward (K5) belongs to the training slice: on CUDA the wrapper
raises for inputs that require a gradient rather than differentiate
through the plain version.

Two layouts reach the kernel without a copy: folded ``[B*H, T, D]``
(``flash_mha``) and packed ``[B, T, H*D]`` (``flash_attention``, the
projections as ``attention_op`` holds them).
"""

from __future__ import annotations

import torch

from .. import kernels as _kernels

BLOCK = 64                       # query rows per block and keys per tile
HEAD_DIMS = tuple(range(16, 129, 16))


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    """Plain K4 on ``[BH, T, D]`` (the JAX ``_ref_mha``): f32 logits and
    softmax, p cast to the value type, output in the query type."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v).to(q.dtype)


def lse_ref(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Row logsumexp ``[BH, T]`` f32 of the logits of ``mha_ref``."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    return torch.logsumexp(s, dim=-1)


def _fold(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, hd = x.shape
    return x.reshape(b, t, heads, hd // heads).transpose(1, 2).reshape(
        b * heads, t, hd // heads)


def _unfold(x: torch.Tensor, heads: int) -> torch.Tensor:
    bh, t, d = x.shape
    return x.reshape(bh // heads, heads, t, d).transpose(1, 2).reshape(
        bh // heads, t, heads * d)


def flash_attention_ref(q, k, v, heads: int, scale: float) -> torch.Tensor:
    """Plain K4 on packed ``[B, T, H*D]``: ``mha_ref`` per head."""
    return _unfold(mha_ref(_fold(q, heads), _fold(k, heads),
                           _fold(v, heads), scale), heads)


def _launch(q, k, v, heads: int, scale: float, save_lse: bool):
    """K4 on ``[N, T, heads*D]`` CUDA tensors read in place; returns the
    output (same shape and type) and the ``[N*heads, T]`` logsumexp or
    None."""
    dev = q.device
    if any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attn_fwd: inputs require a gradient, but the backward "
            "kernel (K5) is not ported; run inference under torch.no_grad()")
    n, t, hd = q.shape
    d = hd // heads if heads > 0 else 0
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.device != dev or x.dtype != q.dtype or x.shape != q.shape
                or not x.is_contiguous()):
            raise ValueError(f"flash_attn_fwd: {name} must be a contiguous "
                             f"{q.dtype} [{n}, {t}, {hd}] tensor on {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attn_fwd: dtype {q.dtype} (bf16 or f32)")
    if heads <= 0 or d * heads != hd or d not in HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd: head dim {hd}/{heads} not in "
                         f"{HEAD_DIMS}")
    if t % BLOCK or t == 0:
        raise ValueError(f"flash_attn_fwd: T={t} not a multiple of {BLOCK}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attn_fwd: inputs must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = (torch.empty((n * heads, t), dtype=torch.float32, device=dev)
           if save_lse else None)
    lib = _kernels.library()
    rc = lib.mvi_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        int(q.dtype == torch.float32), n, heads, t, d, t * hd, hd, d,
        float(scale), _kernels.stream_ptr(dev))
    _kernels.check(rc, "flash_attn_fwd")
    _kernels.LAUNCHES["flash_attn_fwd"] += 1
    return out, lse


def _require_device(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd: unsupported device {x.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float) -> torch.Tensor:
    """Attention over packed ``[B, T, H*D]`` q/k/v (bf16 or f32, T a
    multiple of 64, D in ``HEAD_DIMS``). CPU tensors take the plain
    version; CUDA tensors launch K4; any other device raises."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, heads, scale)
    _require_device(q)
    return _launch(q, k, v, heads, scale, False)[0]


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, save_lse: bool = False):
    """Batched attention over folded ``[BH, T, D]`` tensors (the JAX
    ``flash_mha``); with ``save_lse`` also the ``[BH, T]`` f32 row
    logsumexp. CPU tensors take the plain version, CUDA tensors K4."""
    if q.device.type == "cpu":
        out = mha_ref(q, k, v, scale)
        return (out, lse_ref(q, k, scale)) if save_lse else out
    _require_device(q)
    out, lse = _launch(q, k, v, 1, scale, save_lse)
    return (out, lse) if save_lse else out
