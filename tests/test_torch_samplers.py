"""Port parity, the samplers of slice 9a: ``heun_edm_sample``,
``euler_ancestral_sample``, ``dpmpp2s_ancestral_sample``, ``lms_sample``,
``euler_edm_sample_blended``, ``euler_edm_sample_inversion`` (and
``euler_edm_sample`` with gamma churn), the guiders
``LinearPredictionGuider2`` and ``TrianglePredictionGuider``, the
``api.SamplingPipeline`` and the latent dump, against the JAX package's on
the CPU in f32; and the property checks of ``tests/test_diffusion.py`` on
the port.

The denoiser is analytic, the posterior mean of a Gaussian prior N(m, v)
per entry, D(x, sigma) = (v x + sigma^2 m) / (v + sigma^2), its mean
shifted by the conditioning's ``concat`` so that each half of a CFG batch
(uc | c) has its own; the inversion's raw network output is another
affine map of x. The ladder is the engine's (Karras, sigma 700 to 0.002,
a final 0), at 1, 2, 3 and 10 steps, under each guider.

JAX's draws are handed in: every step's standard normals, made from the
key by the JAX samplers' own splits (``split(k)`` per step, ``split(k,
3)`` for the blended churn and renoise).

The JAX samplers run op by op (``jax.disable_jit()``): the same f32
operations in the same order as their scans, without XLA's fusion. Bar:
1e-5 of max|JAX| (most cases agree bit for bit). Jitted, XLA's fused
evaluation of the same program moves the ill-conditioned steps (the
first step's cancellation of x0 = 700 * noise, Heun's correction at sigma
0.002, whose numerator cancels to ~sigma^2 of |x|) by up to 4e-4
relative against JAX's own op-by-op run; the jitted samplers are held at
1e-5 on the 10-step ladder, where no step is that ill-conditioned.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_inpaint_tpu.diffusion import api as japi
from multiview_inpaint_tpu.diffusion import edm as jedm
from multiview_inpaint_tpu.diffusion import guiders as jguiders
from multiview_inpaint_tpu.diffusion import samplers as jsamplers
from multiview_inpaint_tpu_torch.diffusion import api as tapi
from multiview_inpaint_tpu_torch.diffusion import edm as tedm
from multiview_inpaint_tpu_torch.diffusion import guiders as tguiders
from multiview_inpaint_tpu_torch.diffusion import samplers as tsamplers


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: PyTorch's default threads on the tiny
    networks' many small ops thrash a machine the tests share with
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

T = 3
SHAPE = (T, 4, 6, 4)
CHURN = 0.5
rng = np.random.default_rng(0)
M = rng.normal(size=(2 * T,) + SHAPE[1:]).astype(np.float32)
V = rng.uniform(0.2, 2.0, size=(2 * T,) + SHAPE[1:]).astype(np.float32)
X = rng.normal(size=SHAPE).astype(np.float32)
Z = rng.normal(size=SHAPE).astype(np.float32)
MASK = np.zeros(SHAPE, np.float32)
MASK[:, :2] = 1.0
COND = rng.normal(size=SHAPE).astype(np.float32)
UCOND = rng.normal(size=SHAPE).astype(np.float32)


def _lib(lib):
    if lib is torch:
        return torch.from_numpy
    return jnp.asarray


def _denoisers(lib):
    """(denoise_fn, inv_denoise_fn) in ``lib``."""
    arr = _lib(lib)
    m, v = arr(M), arr(V)

    def denoise(x, sigma, cond):
        b = x.shape[0]
        s2 = (sigma ** 2).reshape(-1, 1, 1, 1)
        mean = m[:b] + 0.5 * cond["concat"]
        return (v[:b] * x + s2 * mean) / (v[:b] + s2)

    def inv_denoise(x, sigma, cond):
        return 0.3 * x - 0.2 * cond["concat"]
    return denoise, inv_denoise


def _conds(lib):
    arr = _lib(lib)
    return {"concat": arr(COND)}, {"concat": arr(UCOND)}


def _guider(lib, name):
    g = tguiders if lib is torch else jguiders
    return {"identity": g.IdentityGuider(),
            "vanilla": g.VanillaCFG(2.0, additional_cond_keys=("concat",)),
            "linear": g.LinearPredictionGuider(num_frames=T,
                                               additional_cond_keys=()),
            "triangle": g.TrianglePredictionGuider(
                num_frames=T, period=(0.5, 1.0), period_fusing="mean",
                additional_cond_keys=())}[name]


def _sigmas(lib, n):
    if lib is torch:
        return torch.cat([tedm.edm_sigmas(n), torch.zeros(1)])
    return jnp.concatenate([jedm.edm_sigmas(n), jnp.zeros((1,))])


def jax_draws(key, n, kinds=1):
    """``kinds`` lists of n standard normals of SHAPE, the draws a JAX
    sampler makes from ``key`` (``split(k, kinds + 1)`` per step)."""
    out = [[] for _ in range(kinds)]
    k = key
    for _ in range(n):
        k, *subs = jax.random.split(k, kinds + 1)
        for lst, sub in zip(out, subs):
            lst.append(torch.from_numpy(np.array(jax.random.normal(
                sub, SHAPE, jnp.float32))))
    return out


def run_pair(name, n, guider, churn, key_seed=5):
    """(port result, JAX result) of one sampler with JAX's draws."""
    key = jax.random.key(key_seed)
    jd, ji = _denoisers(jnp)
    td, ti = _denoisers(torch)
    (jc, juc), (tc, tuc) = _conds(jnp), _conds(torch)
    jg, tg = _guider(jnp, guider), _guider(torch, guider)
    jargs = (jnp.asarray(X), jc, juc, _sigmas(jnp, n))
    targs = (torch.from_numpy(X), tc, tuc, _sigmas(torch, n))
    jzm = (jnp.asarray(Z), jnp.asarray(MASK))
    tzm = (torch.from_numpy(Z), torch.from_numpy(MASK))
    if name == "euler":
        want = jsamplers.euler_edm_sample(jd, *jargs, guider=jg, key=key,
                                          s_churn=churn)
        got = tsamplers.euler_edm_sample(td, *targs, guider=tg,
                                         s_churn=churn,
                                         churn=jax_draws(key, n)[0])
    elif name == "heun":
        want = jsamplers.heun_edm_sample(jd, *jargs, guider=jg, key=key,
                                         s_churn=churn)
        got = tsamplers.heun_edm_sample(td, *targs, guider=tg,
                                        s_churn=churn,
                                        churn=jax_draws(key, n)[0])
    elif name == "blended":
        want = jsamplers.euler_edm_sample_blended(
            jd, *jargs, *jzm, guider=jg, key=key, s_churn=churn)
        eps, ren = jax_draws(key, n, kinds=2)
        got = tsamplers.euler_edm_sample_blended(
            td, *targs, *tzm, guider=tg, s_churn=churn, churn=eps,
            renoise=ren)
    elif name == "inversion":
        want = jsamplers.euler_edm_sample_inversion(
            jd, ji, *jargs, *jzm, inv_guider=jg, key=key, s_churn=churn)
        got = tsamplers.euler_edm_sample_inversion(
            td, ti, *targs, *tzm, inv_guider=tg, s_churn=churn,
            churn=jax_draws(key, n)[0])
    elif name == "ancestral":
        want = jsamplers.euler_ancestral_sample(jd, *jargs, guider=jg,
                                                key=key)
        got = tsamplers.euler_ancestral_sample(
            td, *targs, guider=tg, ancestral=jax_draws(key, n)[0])
    elif name == "dpmpp2s":
        want = jsamplers.dpmpp2s_ancestral_sample(jd, *jargs, guider=jg,
                                                  key=key)
        got = tsamplers.dpmpp2s_ancestral_sample(
            td, *targs, guider=tg, ancestral=jax_draws(key, n)[0])
    else:
        want = jsamplers.lms_sample(jd, *jargs, guider=jg)
        got = tsamplers.lms_sample(td, *targs, guider=tg)
    return got.numpy(), np.asarray(want)


def check(got, want, rel=1e-5, what=""):
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


# Steps and guiders: every step count and every guider, 8 pairs a sampler.
CASES = [(1, "identity"), (2, "vanilla"), (3, "linear"), (10, "triangle"),
         (3, "identity"), (3, "vanilla"), (3, "triangle"), (10, "linear")]
CHURNED = ("euler", "heun", "blended", "inversion")


@pytest.mark.parametrize("churn", [0.0, CHURN])
@pytest.mark.parametrize("n,guider", CASES)
@pytest.mark.parametrize("name", CHURNED)
def test_churn_samplers_match_jax(name, n, guider, churn):
    with jax.disable_jit():
        got, want = run_pair(name, n, guider, churn)
    check(got, want, what=(name, n, guider, churn))


@pytest.mark.parametrize("n,guider", CASES)
@pytest.mark.parametrize("name", ["ancestral", "dpmpp2s", "lms"])
def test_ancestral_and_multistep_samplers_match_jax(name, n, guider):
    with jax.disable_jit():
        got, want = run_pair(name, n, guider, 0.0)
    check(got, want, what=(name, n, guider))


@pytest.mark.parametrize("name", ["heun", "inversion", "dpmpp2s", "lms"])
def test_samplers_match_the_jitted_jax_samplers(name):
    """The jitted JAX scans (XLA's fused evaluation) on the 10-step
    ladder, churned where the sampler churns."""
    got, want = run_pair(name, 10, "vanilla", CHURN)
    check(got, want, what=name)


@pytest.mark.parametrize("order", [1, 2, 4])
@pytest.mark.parametrize("n,smax", [(10, 700.0), (25, 700.0), (7, 20.0)])
def test_lms_coeff_matrix_matches_jax(n, smax, order):
    sig = np.concatenate([np.asarray(jedm.edm_sigmas(n, 0.002, smax)), [0]])
    got = tsamplers._lms_coeff_matrix(sig.astype(np.float32), order)
    want = jsamplers._lms_coeff_matrix(sig.astype(np.float32), order)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames", [3, 14])
@pytest.mark.parametrize("guider,kw", [
    ("LinearPredictionGuider", {}),
    ("LinearPredictionGuider2", {}),
    ("TrianglePredictionGuider", {}),
    ("TrianglePredictionGuider", dict(period=(0.5, 1.0),
                                      period_fusing="max")),
    ("TrianglePredictionGuider", dict(period=(0.3, 0.7, 1.0),
                                      period_fusing="mean")),
    ("TrianglePredictionGuider", dict(period=(0.5, 1.0),
                                      period_fusing="multiply"))])
def test_frame_scales_match_jax(guider, kw, frames):
    args = dict(kw, max_scale=3.0, min_scale=1.5, num_frames=frames)
    got = getattr(tguiders, guider)(**args).frame_scales()
    want = np.asarray(getattr(jguiders, guider)(**args).frame_scales())
    assert got.dtype == torch.float32 and got.shape == (frames,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_linear_prediction_guider2_is_a_no_op():
    g = tguiders.LinearPredictionGuider2(num_frames=T)
    x, s = torch.from_numpy(X), torch.full((T,), 2.0)
    c, uc = _conds(torch)
    gx, gs, gc = g.prepare_inv(x, s, c, uc)
    assert gx is x and gs is s and gc == c
    assert g.combine(x, s) is x


def _pipeline_pair(sampler, key_seed=9):
    """(port, JAX) ``SamplingPipeline.sample`` with JAX's noise and
    draws handed in."""
    p = dict(steps=3, num_frames=T, s_churn=(
        CHURN if sampler in ("HEUN_EDM", "EULER_EDM_BLENDED") else 0.0))
    jp = japi.SamplingPipeline(_denoisers(jnp)[0], japi.SamplingParams(
        sampler=japi.Sampler[sampler], **p),
        inv_denoise_fn=_denoisers(jnp)[1])
    tp = tapi.SamplingPipeline(_denoisers(torch)[0], tapi.SamplingParams(
        sampler=tapi.Sampler[sampler], **p),
        inv_denoise_fn=_denoisers(torch)[1])
    key = jax.random.key(key_seed)
    k1, k2 = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.normal(k1, SHAPE)))
    kinds = 2 if sampler == "EULER_EDM_BLENDED" else 1
    draws = dict(zip({"EULER_EDM_BLENDED": ("churn", "renoise"),
                      "EULER_ANCESTRAL": ("ancestral",),
                      "DPMPP2S_ANCESTRAL": ("ancestral",)}.get(
                          sampler, ("churn",)),
                     jax_draws(k2, 3, kinds)))
    if sampler in ("DPMPP2M", "LINEAR_MULTISTEP"):
        draws = {}
    (jc, juc), (tc, tuc) = _conds(jnp), _conds(torch)
    want = jp.sample(key, SHAPE, jc, juc, z=jnp.asarray(Z),
                     mask=jnp.asarray(MASK))
    got = tp.sample(SHAPE, tc, tuc, z=torch.from_numpy(Z),
                    mask=torch.from_numpy(MASK), noise=noise, device="cpu",
                    **draws)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("sampler", [s.name for s in japi.Sampler])
def test_sampling_pipeline_matches_jax(sampler):
    with jax.disable_jit():
        got, want = _pipeline_pair(sampler)
    check(got, want, what=sampler)


@pytest.mark.parametrize("disc", ["EDM", "LEGACY_DDPM"])
def test_build_sigmas_match_jax(disc):
    got = tapi.build_sigmas(tapi.SamplingParams(
        discretization=tapi.Discretization[disc], steps=10)).numpy()
    want = np.asarray(japi.build_sigmas(japi.SamplingParams(
        discretization=japi.Discretization[disc], steps=10)))
    assert got[-1] == 0 and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=4e-6, atol=0)


def test_pipeline_draws_from_the_generator():
    """Without injected draws the port samples from its generator: the
    same seed gives the same latents, another seed others."""
    tp = tapi.SamplingPipeline(_denoisers(torch)[0], tapi.SamplingParams(
        sampler=tapi.Sampler.DPMPP2S_ANCESTRAL, steps=3, num_frames=T))
    c, uc = _conds(torch)

    def run(seed):
        return tp.sample(SHAPE, c, uc, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    a, b, other = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, other)
    assert torch.isfinite(a).all()


DUMPED = {"euler": "euler", "heun": "heun", "blended": "blended",
          "inversion": "inversion", "ancestral": "ancestral",
          "dpmpp2s": "dpmpp2s", "lms": "lms", "dpmpp2m": "dpmpp2m",
          "unipc": "unipc"}


def _dump(pkg, lib, name, out, n=3):
    """Run one sampler under ``pkg.latent_dump(out)``."""
    den, inv = _denoisers(lib)
    c, uc = _conds(lib)
    arr = _lib(lib)
    sig = _sigmas(lib, n)
    x, z, m = arr(X), arr(Z), arr(MASK)
    jax_side = lib is not torch
    key = jax.random.key(3)
    if jax_side:
        kw = dict(key=key)
        anc = churn = ren = {}
    else:
        d1 = jax_draws(key, n)[0]
        eps, rd = jax_draws(key, n, 2)
        kw = {}
        anc, churn, ren = (dict(ancestral=d1), dict(churn=d1),
                           dict(churn=eps, renoise=rd))
    with pkg.latent_dump(out):
        if name in ("euler", "heun"):
            getattr(pkg, f"{name}_edm_sample")(den, x, c, uc, sig,
                                               s_churn=CHURN, **kw,
                                               **churn)
        elif name == "blended":
            pkg.euler_edm_sample_blended(den, x, c, uc, sig, z, m,
                                         s_churn=CHURN, **kw, **ren)
        elif name == "inversion":
            pkg.euler_edm_sample_inversion(den, inv, x, c, uc, sig, z, m,
                                           **kw)
        elif name == "ancestral":
            pkg.euler_ancestral_sample(den, x, c, uc, sig, **kw, **anc)
        elif name == "dpmpp2s":
            pkg.dpmpp2s_ancestral_sample(den, x, c, uc, sig, **kw, **anc)
        else:
            getattr(pkg, f"{name}_sample")(den, x, c, uc, sig)


@pytest.mark.parametrize("name", list(DUMPED))
def test_latent_dump_matches_jax(name, tmp_path, monkeypatch):
    """The dump of every sampler: the same file names (step index and
    tag), the same sigma ladder and the same latents as JAX's
    ``latent_dump``; no hook stays set. The JAX samplers run op by op, so
    nothing is traced and ``latent_dump``'s ``jax.clear_caches`` has
    nothing to clear (it would only drop the compiled ops)."""
    monkeypatch.setattr(jax, "clear_caches", lambda: None)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    with jax.disable_jit():
        _dump(jsamplers, jnp, name, jdir)
        _dump(tsamplers, torch, name, tdir)
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir))
    steps = 6 if name == "inversion" else 3
    assert len(names) == steps + 1 and "latent_sigmas.npy" in names
    sig_t = np.load(os.path.join(tdir, "latent_sigmas.npy"))
    sig_j = np.load(os.path.join(jdir, "latent_sigmas.npy"))
    np.testing.assert_array_equal(sig_t, sig_j)
    for f in names:
        if f != "latent_sigmas.npy":
            check(np.load(os.path.join(tdir, f)),
                  np.load(os.path.join(jdir, f)), what=f)
    assert tsamplers.set_latent_debug_hook(None) is None


# --- the properties of tests/test_diffusion.py, on the port -----------------

def _gauss(mu, s2):
    def denoise(x, sig, c):
        sg = sig.reshape(-1, 1, 1, 1) ** 2
        return (s2 * x + sg * mu) / (s2 + sg)
    return denoise


def _target(seed, shape=(1, 4, 4, 2)):
    t = torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))
    return t, (lambda x, s, c: t.expand(x.shape))


def _exact(mu, s2, smax, x_start):
    return mu + np.sqrt(s2 / (s2 + smax ** 2)) * (
        x_start * np.sqrt(1.0 + smax ** 2) - mu)


def _ladder(n, smax=700.0):
    return torch.cat([tedm.edm_sigmas(n, 0.002, smax), torch.zeros(1)])


def test_heun_more_accurate_than_euler():
    x0 = torch.ones((1, 4, 4, 2))

    def denoise(x, s, c):
        return x / 2
    sig = _ladder(6, smax=10.0)
    e = tsamplers.euler_edm_sample(denoise, x0, {}, None, sig)
    h = tsamplers.heun_edm_sample(denoise, x0, {}, None, sig)
    assert float(h.abs().mean()) < float(e.abs().mean())


def test_blended_sampler_keeps_background():
    g = np.random.default_rng(3)
    z = torch.from_numpy(g.normal(size=(2, 8, 8, 4)).astype(np.float32))
    mask = torch.zeros((2, 8, 8, 4))
    mask[:, :4] = 1.0
    target = torch.from_numpy(g.normal(size=(2, 8, 8, 4)).astype(
        np.float32))
    x0 = torch.randn(z.shape, generator=torch.Generator().manual_seed(2))
    out = tsamplers.euler_edm_sample_blended(
        lambda x, s, c: target.expand(x.shape), x0, {}, None, _ladder(25),
        z, mask, generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(out[:, :4].numpy(), target[:, :4].numpy(),
                               atol=0.05)
    # the background is blended back at every step: a denoiser that
    # returns its input keeps the renoised z there (sigma 0.002 at the
    # last step)
    out = tsamplers.euler_edm_sample_blended(
        lambda x, s, c: x, x0, {}, None, _ladder(25), z, mask,
        generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(out[:, 4:].numpy(), z[:, 4:].numpy(),
                               atol=0.002 * 6)


def test_inversion_sampler_runs():
    g = np.random.default_rng(4)
    z = torch.from_numpy(g.normal(size=(1, 8, 8, 4)).astype(np.float32))
    out = tsamplers.euler_edm_sample_inversion(
        lambda x, s, c: x * 0.5, lambda x, s, c: x * 0.1, torch.randn(
            z.shape, generator=torch.Generator().manual_seed(3)),
        {}, None, _ladder(8), z, torch.ones_like(z))
    assert torch.isfinite(out).all()


def test_dpmpp2s_ancestral_converges_and_beats_euler_ancestral():
    target, perfect = _target(8)
    x0 = torch.randn(target.shape, generator=torch.Generator().manual_seed(8))
    out = tsamplers.dpmpp2s_ancestral_sample(
        perfect, x0, {}, None, _ladder(25), eta=1.0,
        generator=torch.Generator().manual_seed(9))
    np.testing.assert_allclose(out.numpy(), target.numpy(), atol=0.05)

    mu = torch.from_numpy(np.random.default_rng(9).normal(
        size=(1, 6, 6, 3)).astype(np.float32))
    s2, smax = 0.7 ** 2, 20.0
    sig = _ladder(20, smax)
    x_start = torch.randn(mu.shape, generator=torch.Generator().manual_seed(2))
    exact = _exact(mu, s2, smax, x_start)
    e_eul = float((tsamplers.euler_ancestral_sample(
        _gauss(mu, s2), x_start, {}, None, sig, eta=0.0) - exact).abs().max())
    e_2s = float((tsamplers.dpmpp2s_ancestral_sample(
        _gauss(mu, s2), x_start, {}, None, sig, eta=0.0) - exact).abs().max())
    assert e_2s < 0.3 * e_eul, (e_2s, e_eul)


def test_lms_converges_and_beats_euler():
    target, perfect = _target(10)
    x0 = torch.randn(target.shape,
                     generator=torch.Generator().manual_seed(10))
    out = tsamplers.lms_sample(perfect, x0, {}, None, _ladder(25))
    np.testing.assert_allclose(out.numpy(), target.numpy(), atol=0.05)

    mu = torch.from_numpy(np.random.default_rng(11).normal(
        size=(1, 6, 6, 3)).astype(np.float32))
    s2, smax = 0.7 ** 2, 20.0
    sig = _ladder(20, smax)
    x_start = torch.randn(mu.shape, generator=torch.Generator().manual_seed(2))
    exact = _exact(mu, s2, smax, x_start)
    e_eul = float((tsamplers.euler_edm_sample(
        _gauss(mu, s2), x_start, {}, None, sig) - exact).abs().max())
    e_lms = float((tsamplers.lms_sample(
        _gauss(mu, s2), x_start, {}, None, sig) - exact).abs().max())
    assert e_lms < 0.3 * e_eul, (e_lms, e_eul)
