"""Port parity, the multistep samplers of ``ctrl_inpaint``:
``samplers.dpmpp2m_sample`` and ``samplers.unipc_sample`` against the JAX
package's on the legacy DDPM ladder that ``ctrl_inpaint`` builds
(``edm.legacy_ddpm_sigmas`` with a final 0), on the CPU in f32; and the
schedule itself: the DDPM cumulative alphas within 1e-6 relative of
JAX's, the ladder's sigmas within ``SIGMA_RTOL``.

The denoiser is analytic, the posterior mean of a Gaussian prior N(m, v)
per entry, D(x, sigma) = (v x + sigma^2 m) / (v + sigma^2), with the CFG
batch of ``ctrl_inpaint`` (uc | c halves, each its own m and v) and the
guider's identity. Bars: the sampled latents within 1e-5 of max|JAX| (f32
steps taken in the same order; the JAX loop is one XLA program), at 1, 2,
3, 10 and 30 steps (order 1 at the first steps, the multistep terms
after). The port's loops pick each step's branch on the host; the JAX
scans compute both branches and select.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiview_inpaint_tpu.diffusion import edm as jedm
from multiview_inpaint_tpu.diffusion import samplers as jsamplers
from multiview_inpaint_tpu.guidance.sds import DDPMSchedule as JDDPMSchedule
from multiview_inpaint_tpu_torch.diffusion import edm as tedm
from multiview_inpaint_tpu_torch.diffusion import samplers as tsamplers

SHAPE = (2, 4, 6, 4)
# sigma = sqrt((1 - acp) / acp) magnifies a relative difference in acp by
# 1 / (2 (1 - acp)): ~25x at the second entry of a 50-step ladder (acp
# 0.98), where the two packages' f32 schedules (each within 6.3e-7 of the
# float64 one) land 2.0e-6 apart; JAX's own f32 ladder is off its float64
# values by up to 1.3e-5.
SIGMA_RTOL = 4e-6


def _prior(lib):
    rng = np.random.default_rng(0)
    m = rng.normal(size=SHAPE).astype(np.float32)
    v = rng.uniform(0.2, 2.0, size=SHAPE).astype(np.float32)
    if lib is torch:
        m, v = torch.from_numpy(m), torch.from_numpy(v)
    else:
        m, v = jnp.asarray(m), jnp.asarray(v)

    def denoise(x, sigma_vec, cond):
        s2 = (sigma_vec ** 2).reshape(-1, 1, 1, 1)
        return (v * x + s2 * m) / (v + s2)
    return denoise


def _sigmas(lib, n):
    if lib is torch:
        return torch.cat([tedm.legacy_ddpm_sigmas(n), torch.zeros(1)])
    return jnp.concatenate([jedm.legacy_ddpm_sigmas(n), jnp.zeros((1,))])


def test_ddpm_alphas_cumprod_match_jax():
    got = tedm.ddpm_alphas_cumprod().numpy()
    want = np.asarray(JDDPMSchedule().alphas_cumprod())
    assert got.dtype == np.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [10, 30, 50])
def test_legacy_ddpm_sigmas_match_jax(n):
    got = tedm.legacy_ddpm_sigmas(n).numpy()
    want = np.asarray(jedm.legacy_ddpm_sigmas(n))
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=SIGMA_RTOL, atol=0)


@pytest.mark.parametrize("sampler", ["dpmpp2m_sample", "unipc_sample"])
@pytest.mark.parametrize("n", [1, 2, 3, 10, 30])
def test_multistep_sampler_matches_jax(sampler, n):
    x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    got = getattr(tsamplers, sampler)(_prior(torch), torch.from_numpy(x),
                                      {}, None, _sigmas(torch, n)).numpy()
    want = np.asarray(getattr(jsamplers, sampler)(
        _prior(jnp), jnp.asarray(x), {}, None, _sigmas(jnp, n)))
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err
