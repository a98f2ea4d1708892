"""Port parity, attention: the plain version of the flash-attention
kernel (K4) against the JAX reference attention (``_ref_mha``) and against
the Pallas kernel itself in interpret mode (in a clean subprocess), and
``attention_op``'s routing.

Bars: f32 inputs 1e-6 of max|out| (the same f32 math, summed in another
order); bf16 inputs 1e-2 absolute at unit-normal q, k, v (one bf16
rounding of outputs of size ~1 is 4e-3, and p is rounded to bf16 before
p.v in both); against the Pallas kernel 0.02, the bar of
``tests/test_flash_attention.py`` (the online softmax rescales p and the
sums in another order).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_inpaint_tpu.diffusion import attention_op as jattention_op
from multiview_inpaint_tpu.diffusion.flash_attention import _ref_mha
from multiview_inpaint_tpu_torch.diffusion import attention_op
from multiview_inpaint_tpu_torch.diffusion import flash_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(bh, t, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, t, d)).astype(np.float32)
            for _ in range(3)]


def _bf16(x):
    """numpy f32 -> the bf16 values both frameworks see."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k4_matches_ref_mha(dtype):
    q, k, v = (_bf16(a) if dtype == "bfloat16" else a
               for a in _qkv(3, 96, 32))
    scale = 32 ** -0.5
    want = np.asarray(_ref_mha(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                               scale).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = fa.mha_ref(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                     scale)
    assert got.dtype == tdt
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= (1e-2 if dtype == "bfloat16" else
                   1e-6 * np.abs(want).max()), err


def test_flash_mha_cpu_is_plain_and_saves_lse():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 64, 16, 1))
    out, lse = fa.flash_mha(q, k, v, 0.25, save_lse=True)
    assert torch.equal(out, fa.mha_ref(q, k, v, 0.25))
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * 0.25
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(
        s, -1).numpy(), rtol=1e-6)
    assert lse.shape == (2, 64) and lse.dtype == torch.float32


def test_packed_layout_equals_folded():
    """``flash_attention`` on [B, T, H*D] is ``flash_mha`` per head."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 64, 3 * 16)).astype(
        np.float32)) for _ in range(3))
    got = fa.flash_attention(q, k, v, 3, 0.25)

    def fold(x):
        return x.reshape(2, 64, 3, 16).transpose(1, 2).reshape(6, 64, 16)
    want = fa.flash_mha(fold(q), fold(k), fold(v), 0.25).reshape(
        2, 3, 64, 16).transpose(1, 2).reshape(2, 64, 48)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


_PALLAS_FLASH = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from multiview_inpaint_tpu.diffusion.flash_attention import flash_mha
    d = dict(np.load(sys.argv[1]))
    q, k, v = (jnp.asarray(d[n], jnp.bfloat16) for n in "qkv")
    out = flash_mha(q, k, v, float(d["scale"]), True)
    np.save(sys.argv[2], np.asarray(out.astype(jnp.float32)))
""")


@pytest.mark.parametrize("t", [256, 512])
def test_plain_k4_matches_pallas_flash_interpret(tmp_path, t):
    """The TPU kernel itself, in interpret mode, in a clean subprocess
    (interpret-mode Pallas can crash a long-lived XLA:CPU process)."""
    q, k, v = (_bf16(a) for a in _qkv(2, t, 32, t))
    scale = 32 ** -0.5
    inputs, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npy")
    np.savez(inputs, q=q, k=k, v=v, scale=scale)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", _PALLAS_FLASH, inputs, out],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out)
    got = fa.mha_ref(*(torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v)), scale).float().numpy()
    assert np.abs(got - want).max() < 0.02


@pytest.mark.parametrize("shape,flash", [
    ((3072, 3072, 64), True),    # ds1 spatial self-attention (SVD)
    ((768, 768, 64), True),      # ds2 spatial self-attention
    ((192, 192, 64), False),     # ds4: shorter than 768
    ((48, 48, 64), False),       # ds8 middle
    ((14, 14, 64), False),       # temporal blocks: the 14 frames
    ((3072, 1, 64), False),      # cross-attention to the CLIP token
    ((1000, 1000, 64), False),   # not a multiple of 256
    ((1024, 1024, 160), False),  # head dim above 128
    ((1024, 1024, 40), True),    # padded to 48 for the kernels
    ((1024, 1024, 128), True),
])
def test_routing_rule(shape, flash):
    assert attention_op.routes_to_flash(*shape) is flash


def test_routing_never_takes_the_kernel_on_the_cpu(monkeypatch):
    """A CPU tensor of a routed shape takes the plain math, which matches
    JAX's ``attention`` (itself on its XLA path on the CPU)."""
    def no_kernel(*a, **kw):
        raise AssertionError("K4 called for a CPU tensor")
    monkeypatch.setattr(attention_op, "flash_attention", no_kernel)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 768, 2 * 16)).astype(np.float32)
    k, v = (rng.normal(size=q.shape).astype(np.float32) for _ in range(2))
    got = attention_op.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 heads=2)
    want = jattention_op.attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   heads=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("tq,tk,dtype", [(14, 14, "float32"),
                                         (20, 1, "float32"),
                                         (14, 14, "bfloat16")])
def test_plain_attention_matches_jax_dot_product_attention(tq, tk, dtype):
    rng = np.random.default_rng(4)
    q = _bf16(rng.normal(size=(5, tq, 4 * 8)).astype(np.float32))
    k, v = (_bf16(rng.normal(size=(5, tk, 4 * 8)).astype(np.float32))
            for _ in range(2))
    want = np.asarray(jattention_op.attention(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), heads=4).astype(
        jnp.float32))
    got = attention_op.attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        heads=4)
    assert got.dtype == getattr(torch, dtype)
    bar = 1e-2 if dtype == "bfloat16" else 1e-6
    assert np.abs(got.float().numpy() - want).max() <= bar


def test_k4_wrapper_rejects_other_devices_and_gradients():
    q = torch.zeros((1, 64, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_mha(q, q, q, 0.25)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q, 1, 0.25)
    # the gradient check comes first among the kernel's argument checks
    x = torch.zeros((1, 64, 16), requires_grad=True)
    with pytest.raises(RuntimeError, match="K5"):
        fa._launch(x, x, x, 1, 0.25, False)
