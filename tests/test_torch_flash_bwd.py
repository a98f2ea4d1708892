"""Port parity, the flash-attention backward: the plain version of K5
(``flash_attention.mha_bwd_ref``) against autograd through the plain
forward, against the Pallas K5 itself in interpret mode (``jax.vjp`` of
``flash_mha(..., interpret=True)`` in a clean subprocess), packed against
folded, and the differentiable ``FlashAttention`` on CPU tensors.

Bars: f32 1e-5 of max|grad| (the same f32 math, summed in another order;
the plain K5 rounds p and ds to the input type, which is no rounding in
f32); bf16 against autograd 0.02 of max|grad| (autograd through the bf16
forward rounds p.v's cotangent path differently: p.to(bf16)'s backward
passes dp unrounded); against the Pallas kernel 0.02 of max|grad| (bf16
outputs, another summation order), the bar of the forward's parity test.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiview_inpaint_tpu_torch.diffusion import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _bf16(x):
    """numpy f32 -> the bf16 values both frameworks see."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _autograd(q, k, v, do, scale):
    qa, ka, va = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fa.mha_ref(qa, ka, va, scale)
    return torch.autograd.grad(out, (qa, ka, va), do)


def _plain(q, k, v, do, scale):
    o = fa.mha_ref(q, k, v, scale)
    return fa.mha_bwd_ref(q, k, v, o, fa.lse_ref(q, k, scale), do, scale)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.02)])
@pytest.mark.parametrize("t,d", [(64, 16), (96, 32)])
def test_plain_k5_matches_autograd_through_plain_k4(dtype, bar, t, d):
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _arrays(4, (3, t, d), t + d))
    scale = d ** -0.5
    got = _plain(q, k, v, do, scale)
    want = _autograd(q, k, v, do, scale)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(g, w) <= bar, (name, _rel(g, w))


def test_plain_k5_sees_its_delta_and_every_key():
    """The two planted faults of the card's check move the plain K5 far
    beyond its bar: without delta, and without the first 64 keys."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(4, (2, 128, 16), 7))
    scale = 0.25
    o = fa.mha_ref(q, k, v, scale)
    lse = fa.lse_ref(q, k, scale)
    good = fa.mha_bwd_ref(q, k, v, o, lse, do, scale)
    no_delta = fa.mha_bwd_ref(q, k, v, torch.zeros_like(o), lse, do, scale)
    assert _rel(no_delta[0], good[0]) > 0.1
    # dropping the first 64 keys: their dk, dv and their share of dq go
    kk, vv = k[:, 64:], v[:, 64:]
    part = fa.mha_bwd_ref(q, kk, vv, o, lse, do, scale)
    assert _rel(part[0], good[0]) > 0.1


def test_packed_layout_equals_folded():
    """``flash_attention_bwd_ref`` on [B, T, H*D] is ``mha_bwd_ref`` per
    head on the folded [B*H, T, D]."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(4, (2, 64, 48), 3))
    heads, scale = 3, 0.25
    o = fa.flash_attention_ref(q, k, v, heads, scale)
    lse = fa.lse_ref(fa._fold(q, heads), fa._fold(k, heads), scale)
    packed = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, heads, scale)
    folded = fa.mha_bwd_ref(*(fa._fold(x, heads) for x in (q, k, v, o)),
                            lse, fa._fold(do, heads), scale)
    for a, b in zip(packed, folded):
        torch.testing.assert_close(a, fa._unfold(b, heads), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.02)])
def test_autograd_function_on_cpu_is_plain_k4_and_k5(dtype, bar):
    """``FlashAttention`` on CPU tensors: its output is the plain K4, its
    gradients the plain K5 (so autograd through the plain math, within
    the bars above)."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _arrays(4, (2, 64, 2 * 16), 5))
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.FlashAttention.apply(qa, ka, va, 2, 0.25)
    assert torch.equal(out, fa.flash_attention_ref(q, k, v, 2, 0.25))
    got = torch.autograd.grad(out, (qa, ka, va), do)
    o = fa.flash_attention_ref(q, k, v, 2, 0.25)
    lse = fa.lse_ref(fa._fold(q, 2), fa._fold(k, 2), 0.25)
    plain = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, 2, 0.25)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    qb, kb, vb = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(fa.flash_attention_ref(qb, kb, vb, 2, 0.25),
                               (qb, kb, vb), do)
    for g, w in zip(got, want):
        assert _rel(g, w) <= bar


def test_flash_attention_differentiates_through_the_function():
    """``flash_attention`` on inputs that require a gradient takes the
    ``FlashAttention`` route (K4 saving the logsumexp, K5 backward), so
    its gradients are the Function's bit for bit; without a gradient it is
    the plain K4."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(4, (1, 64, 32), 6))
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(qa, ka, va, 2, 0.25)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    got = torch.autograd.grad(out, (qa, ka, va), do)
    qb, kb, vb = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(fa.FlashAttention.apply(qb, kb, vb, 2, 0.25),
                               (qb, kb, vb), do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert torch.equal(fa.flash_attention(qa, ka, va, 2, 0.25),
                           fa.flash_attention_ref(q, k, v, 2, 0.25))


_PALLAS_BWD = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from multiview_inpaint_tpu.diffusion.flash_attention import flash_mha
    d = dict(np.load(sys.argv[1]))
    q, k, v, g = (jnp.asarray(d[n], jnp.bfloat16) for n in ("q", "k", "v",
                                                             "g"))
    scale = float(d["scale"])
    out, vjp = jax.vjp(lambda a, b, c: flash_mha(a, b, c, scale, True),
                       q, k, v)
    dq, dk, dv = vjp(g)
    np.savez(sys.argv[2], **{n: np.asarray(x.astype(jnp.float32))
                             for n, x in (("dq", dq), ("dk", dk),
                                          ("dv", dv))})
""")


@pytest.mark.parametrize("t", [256, 512])
def test_plain_k5_matches_pallas_backward_interpret(tmp_path, t):
    """The TPU kernel itself (``_bwd_kernel`` through the custom VJP of
    ``flash_mha``), in interpret mode, in a clean subprocess."""
    q, k, v, g = (_bf16(a) for a in _arrays(4, (2, t, 32), t + 1))
    scale = 32 ** -0.5
    inputs, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(inputs, q=q, k=k, v=v, g=g, scale=scale)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", _PALLAS_BWD, inputs, out],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out)
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, g))
    got = _plain(tq, tk, tv, tg, scale)
    for name, x in zip(("dq", "dk", "dv"), got):
        w = torch.from_numpy(want[name])
        assert _rel(x, w) <= 0.02, (name, _rel(x, w))
