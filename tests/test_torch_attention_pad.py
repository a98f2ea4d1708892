"""Head dims that the flash kernels do not take, padded on the way in.

K4 and K5 take head dims in ``flash_attention.HEAD_DIMS`` (multiples of
16). ``attention_op`` sends every long self-attention of head dim <= 128
to them, as the JAX op sends it to its Pallas kernel, and zero-pads any
other head dim per head to the next of those (``flash_padded``), slicing
the output back. These tests run the padding on the CPU, where
``flash_attention`` is the kernels' plain version: the padded-then-sliced
attention and its gradients equal the unpadded plain attention (to f32
summation order; in bf16 to one rounding of the outputs).
"""

import numpy as np
import pytest
import torch

from multiview_inpaint_tpu_torch.diffusion import attention_op
from multiview_inpaint_tpu_torch.diffusion import flash_attention as fa


@pytest.mark.parametrize("d", [40, 8, 72, 120])
def test_routes_every_head_dim_up_to_128(d):
    assert attention_op.routes_to_flash(768, 768, d)
    assert not attention_op.routes_to_flash(768, 768, 136)


@pytest.mark.parametrize("d,heads,dtype,tol", [
    (40, 2, torch.float32, 2e-6), (8, 3, torch.float32, 2e-6),
    (40, 2, torch.bfloat16, 8e-3)])
def test_padded_attention_and_gradient_equal_the_unpadded(d, heads, dtype,
                                                          tol):
    rng = np.random.default_rng(d + heads)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 128, heads * d))
                                    .astype(np.float32)).to(dtype)
                   for _ in range(4))
    scale = d ** -0.5
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    got = attention_op.flash_padded(qa, ka, va, heads, scale)
    grads = torch.autograd.grad(got, (qa, ka, va), do)
    qb, kb, vb = (x.clone().requires_grad_() for x in (q, k, v))
    want = fa.flash_attention_ref(qb, kb, vb, heads, scale)
    wants = torch.autograd.grad(want, (qb, kb, vb), do)
    assert got.shape == want.shape and got.dtype == dtype
    for g, w in [(got, want)] + list(zip(grads, wants)):
        g, w = g.detach().float(), w.detach().float()
        err = float((g - w).abs().max())
        assert err <= tol * float(w.abs().max()) + tol, err


def test_padding_leaves_kernel_head_dims_alone(monkeypatch):
    """A head dim the kernels take goes in as it is, without a copy."""
    seen = []
    monkeypatch.setattr(attention_op, "flash_attention",
                        lambda q, k, v, h, s: seen.append(q) or q)
    q = torch.zeros((1, 768, 2 * 48))
    attention_op.flash_padded(q, q, q, 2, 0.1)
    assert seen[0] is q
