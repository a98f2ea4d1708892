"""Port parity, losses and quaternions: ``utils/losses`` (L1, SSIM with
its float32 blur and that blur's own backward, PSNR, the photometric
loss) and ``utils/quaternion.quat_to_rotmat`` against the JAX package on
the CPU, inputs from numpy seeds. Tolerance 1e-6 (float32, sums taken in
another order), gradients at 2e-6 + 1e-4 max|g|.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_inpaint_tpu.utils import losses as jlosses
from multiview_inpaint_tpu.utils import quaternion as jquat
from multiview_inpaint_tpu_torch.utils import losses as tlosses
from multiview_inpaint_tpu_torch.utils import quaternion as tquat

TOL = 1e-6


def _pair(seed, shape=(3, 40, 56), noise=0.05):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=noise, size=shape), 0, 1).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_l1_ssim_psnr_photometric_match_jax(seed):
    a, b = _pair(seed)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("l1_loss", "l2_loss", "ssim", "photometric_loss"):
        got = float(getattr(tlosses, name)(ta, tb))
        want = float(getattr(jlosses, name)(ja, jb))
        assert abs(got - want) <= TOL, (name, got, want)
    got = tlosses.psnr(ta[None], tb[None]).numpy()
    want = np.asarray(jlosses.psnr(ja[None], jb[None]))
    assert got.shape == want.shape == (1, 1, 1, 1)
    np.testing.assert_allclose(got, want, rtol=TOL)
    np.testing.assert_allclose(tlosses._gaussian_window(11, 1.5).numpy(),
                               np.asarray(jlosses._gaussian_window(11, 1.5)),
                               atol=1e-8)


def test_ssim_gradient_matches_jax():
    """The blur's hand-written backward (the same blur of the cotangent)
    against JAX autodiff through its convolutions."""
    a, b = _pair(2, shape=(3, 33, 45), noise=0.2)
    want = np.asarray(jax.grad(lambda x: jlosses.photometric_loss(
        x, jnp.asarray(b)))(jnp.asarray(a)))
    ta = torch.from_numpy(a).requires_grad_(True)
    tlosses.photometric_loss(ta, torch.from_numpy(b)).backward()
    np.testing.assert_allclose(ta.grad.numpy(), want,
                               atol=2e-6 + 1e-4 * np.abs(want).max())


def test_ssim_bounds_and_blur_adjoint():
    a, _ = _pair(3)
    ta = torch.from_numpy(a)
    assert abs(float(tlosses.ssim(ta, ta)) - 1.0) <= TOL
    smooth = torch.linspace(0.2, 0.8, 56).expand(3, 40, 56).contiguous()
    assert float(tlosses.ssim(smooth, smooth + 1e-3)) <= 1.0
    # <blur x, y> == <x, blur y>: the backward is the forward's adjoint.
    rng = np.random.default_rng(4)
    x, y = (torch.from_numpy(rng.random((2, 17, 23)).astype(np.float64))
            for _ in range(2))
    w = tlosses._gaussian_window(11, 1.5).double()
    lhs = float((tlosses._blur(x, w) * y).sum())
    rhs = float((x * tlosses._blur(y, w)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_quat_to_rotmat_matches_jax():
    q = np.random.default_rng(5).normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0   # degenerate quaternion: the 1e-12 guard
    got = tquat.quat_to_rotmat(torch.from_numpy(q)).numpy()
    want = np.asarray(jquat.quat_to_rotmat(jnp.asarray(q)))
    np.testing.assert_allclose(got, want, atol=TOL)
