"""The flash-attention kernels, forward (K4) and backward (K5), and their
plain versions.

Counterpart of ``multiview_inpaint_tpu/diffusion/flash_attention.py``
(``_kernel`` via ``_flash_fwd_impl``, ``_bwd_kernel`` via
``_flash_bwd_impl``, and the ``flash_mha`` custom VJP): non-causal,
unmasked multi-head attention with f32 logits, an f32 softmax, p rounded
to the value type before p.v, and an f32 sum. The CUDA sources are
``csrc/flash_attn_fwd.cu`` (one block per head and 192 query rows: a TMA
producer warpgroup and three wgmma consumer warpgroups, the online softmax
in registers) and ``csrc/flash_attn_bwd.cu`` (a dk/dv pass per 128 keys
and a dq pass per 128 queries, from the forward's row logsumexp; their
notes say more). The kernels take bf16 operands: f32 inputs are rounded
to bf16 once here, as the TPU kernels' products round them, and the
outputs come back in f32 from the f32 accumulators. So the f32 path keeps
bf16 operands with f32 sums; its results differ from the f32 plain
versions by bf16 rounding of the operands (a few 1e-3 at unit-normal
inputs).

``FlashAttention`` is the differentiable form: its forward is K4 with the
logsumexp saved, its backward K5, on CUDA tensors; on CPU tensors both
are the plain versions.

Two layouts reach the kernels without a copy: folded ``[B*H, T, D]``
(``flash_mha``) and packed ``[B, T, H*D]`` (``flash_attention``, the
projections as ``attention_op`` holds them).
"""

from __future__ import annotations

import torch

from .. import kernels as _kernels
from .. import telemetry

BLOCK = 128                      # T must be a multiple of this
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


def mha_bwd_ref(q, k, v, o, lse, do, scale: float):
    """Plain K5 on ``[BH, T, D]``: (dq, dk, dv) in the input type from the
    forward's output ``o`` and row logsumexp ``lse`` ``[BH, T]`` f32 and
    the output's cotangent ``do``, step by step as the JAX kernel computes
    them: delta = rowsum(dO o) in f32, p = exp(s scale - lse), dv = p^T dO
    with p rounded to the input type, dp = dO v^T, ds = p (dp - delta)
    scale rounded to the input type, dk = ds^T q, dq = ds k, every product
    summed in f32."""
    dt = q.dtype
    delta = (do.float() * o.float()).sum(-1)
    do = do.to(dt).float()
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p.to(dt).float(), do)
    dp = torch.einsum("bqd,bkd->bqk", do, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


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


def flash_attention_bwd_ref(q, k, v, o, lse, do, heads: int, scale: float):
    """Plain K5 on packed ``[B, T, H*D]`` (``lse`` ``[B*H, T]``):
    ``mha_bwd_ref`` per head."""
    grads = mha_bwd_ref(*(_fold(x, heads) for x in (q, k, v, o)), lse,
                        _fold(do, heads), scale)
    return tuple(_unfold(g, heads) for g in grads)


def _check(name, q, others, heads):
    """The kernels' argument rules: same contiguous shape, type and device
    for every operand; bf16 or f32; T a multiple of ``BLOCK``; head dim in
    ``HEAD_DIMS``; 16-byte aligned."""
    n, t, hd = q.shape
    d = hd // heads if heads > 0 else 0
    for x in (q,) + tuple(others):
        if (x.device != q.device or x.dtype != q.dtype or x.shape != q.shape
                or not x.is_contiguous()):
            raise ValueError(f"{name}: operands must be contiguous "
                             f"{q.dtype} [{n}, {t}, {hd}] tensors on "
                             f"{q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {q.dtype} (bf16 or f32)")
    if heads <= 0 or d * heads != hd or d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd}/{heads} not in {HEAD_DIMS}")
    if t % BLOCK or t == 0:
        raise ValueError(f"{name}: T={t} not a multiple of {BLOCK}")
    if any(x.data_ptr() % 16 for x in (q,) + tuple(others)):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    return n, t, hd, d


def _bf16(*xs):
    """The kernels' operands: bf16 as they are, f32 rounded to bf16 (to
    nearest even)."""
    return tuple(x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
                 for x in xs)


def _launch(q, k, v, heads: int, scale: float, save_lse: bool):
    """K4 on ``[N, T, heads*D]`` CUDA tensors read in place; returns the
    output (same shape and type) and the ``[N*heads, T]`` logsumexp or
    None. It takes no gradient: ``flash_attention`` sends inputs that
    require one through ``FlashAttention``, whose forward calls this with
    autograd off."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attn_fwd: inputs require a gradient; differentiate "
            "through FlashAttention, whose backward is K5")
    n, t, hd, d = _check("flash_attn_fwd", q, (k, v), heads)
    out = torch.empty_like(q)
    lse = (torch.empty((n * heads, t), dtype=torch.float32, device=q.device)
           if save_lse else None)
    lib = _kernels.library()
    qb, kb, vb = _bf16(q, k, v)
    rc = lib.mvi_flash_attn_fwd(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        int(q.dtype == torch.float32), n, heads, t, d, t * hd, hd, d,
        float(scale), _kernels.stream_ptr(q.device))
    _kernels.check(rc, "flash_attn_fwd")
    telemetry.count("launch.flash_attn_fwd")
    return out, lse


def _delta(do, o, heads: int) -> torch.Tensor:
    """rowsum(dO o) in f32 per head and row, ``[N*heads, T]``."""
    n, t, hd = o.shape
    prod = (do.float() * o.float()).reshape(n, t, heads, hd // heads)
    return prod.sum(-1).transpose(1, 2).reshape(n * heads, t).contiguous()


def _launch_bwd(q, k, v, o, lse, do, heads: int, scale: float):
    """K5 on ``[N, T, heads*D]`` CUDA tensors read in place (``do`` in
    any float type, cast to the input type as the JAX backward does);
    returns (dq, dk, dv) in the input's shape and type. One call is one
    count: the dk/dv kernel and the dq kernel, launched back to back."""
    delta = _delta(do, o, heads)
    do = do.to(q.dtype).contiguous()
    n, t, hd, d = _check("flash_attn_bwd", q, (k, v, do), heads)
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.dtype != torch.float32 or x.shape != (n * heads, t)
                or x.device != q.device or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"flash_attn_bwd: {name} must be a contiguous, "
                             f"16-byte aligned f32 [{n * heads}, {t}] tensor "
                             f"on {q.device}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _kernels.library()
    qb, kb, vb, dob = _bf16(q, k, v, do)
    rc = lib.mvi_flash_attn_bwd(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), dob.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), int(q.dtype == torch.float32), n, heads, t, d,
        t * hd, hd, d, float(scale), _kernels.stream_ptr(q.device))
    _kernels.check(rc, "flash_attn_bwd")
    telemetry.count("launch.flash_attn_bwd")
    return dq, dk, dv


def _require_device(x: torch.Tensor, name: str = "flash_attn_fwd") -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float) -> torch.Tensor:
    """Attention over packed ``[B, T, H*D]`` q/k/v (bf16 or f32, T a
    multiple of ``BLOCK``, D in ``HEAD_DIMS``). CPU tensors take the plain
    version; CUDA tensors launch K4, with no logsumexp written unless an
    input carries a gradient: then ``FlashAttention`` (K4 saving it, K5 as
    the backward); any other device raises."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, heads, scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, heads, scale)
    _require_device(q)
    return _launch(q, k, v, heads, scale, False)[0]


def flash_attention_bwd(q, k, v, o, lse, do, heads: int, scale: float):
    """(dq, dk, dv) of packed attention from the forward's output and
    logsumexp: the plain version on CPU tensors, K5 on CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, heads, scale)
    _require_device(q, "flash_attn_bwd")
    return _launch_bwd(q, k, v, o, lse, do, heads, scale)


class FlashAttention(torch.autograd.Function):
    """Differentiable packed attention: the forward is K4 saving the row
    logsumexp, the backward K5 (the JAX ``flash_mha`` custom VJP); on CPU
    tensors, their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        if q.device.type == "cpu":
            out = flash_attention_ref(q, k, v, heads, scale)
            lse = lse_ref(_fold(q, heads), _fold(k, heads), scale)
        else:
            _require_device(q)
            out, lse = _launch(q, k, v, heads, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.heads, ctx.scale)
        return dq, dk, dv, None, None


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
