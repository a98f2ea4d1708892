"""Port parity, the SVD engine's blended and inversion sampling: the raw
network output (``edm.raw_net_out`` through ``SVDEngine.inv_denoise_fn``),
``SVDEngine.sample_blended`` and ``sample_inversion`` against the JAX
engine's, the ``svd_test --sampling blended|inversion --dump_latents`` CLI,
and its latent mask against ``jax.image.resize(..., "nearest")``.

The tiny engine is ``svd_test --tiny_model`` at 3 frames and 64x48 images
in f32: the port's random weights, every one moved by a seeded N(0,
0.05^2) draw, carried into the JAX layout (``checkpoint.state_dict_to_jax``;
the JAX engine is never initialised). Both engines take the same random
per-frame conditioning (c, and uc with CLIP tokens and latents zeroed as
the conditioner's ``force_zero`` gives them). JAX's initial noise and the
blended sampler's per-step renoise are handed in, made from the key by
the JAX engine's own splits.

The JAX samplers run op by op (``jax.disable_jit()``) around a jitted
``apply_model`` applied one video at a time: one XLA compile of the
networks instead of one per scan. Bars: one network evaluation within
1e-4 of the largest magnitude (f32 sums in another order through ~40
layers); the 2-step
latents within 1e-4 of theirs plus 4 f32 spacings at the entry's
magnitude entering the first step (the first Euler step from sigma 700
cancels it down to the denoised latents, so each rounding there is at
that scale: |x0| = sqrt(1 + 700^2) |noise| in the sampled region, and for
the inversion the top inverted latent outside it, ~2e5 after the 2-step
ladder's jump from 0.002 to 700).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_inpaint_tpu.diffusion import engine as jengine
from multiview_inpaint_tpu.diffusion import samplers as jsamplers
from multiview_inpaint_tpu.pipelines import svd_test as jsvd_test
from multiview_inpaint_tpu_torch.data.svd_dataset import GSVideoForwardDataset
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.diffusion import engine as tengine
from multiview_inpaint_tpu_torch.diffusion import samplers as tsamplers
from multiview_inpaint_tpu_torch.gs import scene_io
from multiview_inpaint_tpu_torch.guidance.sds import resize_nearest
from multiview_inpaint_tpu_torch.pipelines import svd_test
from multiview_inpaint_tpu_torch.utils import synthetic


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: PyTorch's default threads on the tiny
    networks' many small ops thrash a machine the tests share with
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

T, STEPS, SIZE = 3, 2, (64, 48)
LAT = (T, SIZE[0] // 8, SIZE[1] // 8, 4)
COMPONENTS = ("unet", "controlnet", "vae", "clip")
REL_TOL, X0_ULPS = 1e-4, 4


def _args():
    return argparse.Namespace(tiny_model=True, num_frames=T,
                              num_steps=STEPS, compute_dtype="float32")


def _nested(flat):
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return out


@pytest.fixture(scope="module")
def engines():
    """(JAX engine with a jitted ``apply_model``, JAX state, port
    engine): the port's moved weights in both."""
    cfg = jsvd_test._engine_config(_args())
    teng = tengine.init_engine(svd_test._engine_config(_args()),
                               device="cpu")
    gen = torch.Generator().manual_seed(60)
    with torch.no_grad():
        for p in teng.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    flat = checkpoint.state_dict_to_jax(teng.reference_state_dict(),
                                        clip_heads=cfg.vit.heads)
    state = jengine.EngineState(**{c: _nested(
        {k[len(c) + 1:]: v for k, v in flat.items()
         if k.startswith(c + "/")}) for c in COMPONENTS})
    jeng = jengine.SVDEngine(cfg)
    apply = jax.jit(jeng.apply_model)

    def apply_model(st, x, t_noise, cond):
        """The jitted networks, one video of T frames at a time (the
        videos of a CFG batch do not interact), so that one compile
        serves every call."""
        with jax.disable_jit(False):
            return jnp.concatenate([apply(
                st, x[i:i + T], t_noise[i:i + T],
                {k: v[i:i + T] for k, v in cond.items()})
                for i in range(0, x.shape[0], T)])
    jeng.apply_model = apply_model
    return jeng, state, teng


def _conds():
    """((JAX c, uc), (port c, uc)): random per-frame conditioning."""
    rng = np.random.default_rng(61)
    c = {"crossattn": rng.normal(size=(T, 1, 16)),
         "vector": rng.normal(size=(T, 768)),
         "concat": rng.normal(size=LAT),
         "control_hint": rng.uniform(size=(T,) + SIZE + (7,))}
    c = {k: v.astype(np.float32) for k, v in c.items()}
    uc = dict(c, crossattn=np.zeros_like(c["crossattn"]),
              concat=np.zeros_like(c["concat"]))
    return (tuple({k: jnp.asarray(v) for k, v in d.items()} for d in (c, uc)),
            tuple({k: torch.from_numpy(v) for k, v in d.items()}
                  for d in (c, uc)))


def _bg():
    rng = np.random.default_rng(62)
    z = rng.normal(size=LAT).astype(np.float32)
    mask = np.zeros(LAT, np.float32)
    mask[:, 2:6, 1:4] = 1.0
    return z, mask


def _spacing(x):
    """The f32 spacing at each entry of ``x`` (numpy)."""
    x = np.abs(np.asarray(x, np.float32))
    return np.ldexp(np.ones_like(x), np.frexp(np.maximum(x, 1e-30))[1] - 24)


def _check(got, want, what, bar=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want)
    full = REL_TOL * float(np.abs(want).max()) + (0 if bar is None else bar)
    assert (err <= full).all(), (what, float(err.max()),
                                 float(np.max(full)))


def test_raw_net_out_and_denoiser_match_jax(engines):
    """One evaluation of ``inv_denoise_fn`` (the raw network output) and
    of ``denoise_fn`` at one sigma per frame; the raw output is the
    denoiser's before its scalings."""
    jeng, state, teng = engines
    (jc, _), (tc, _) = _conds()
    x = np.random.default_rng(63).normal(size=LAT).astype(np.float32) * 3
    sig = np.array([0.5, 3.7, 40.0], np.float32)
    with jax.disable_jit():
        want = jeng.inv_denoise_fn(state)(jnp.asarray(x), jnp.asarray(sig),
                                          jc)
        want_d = jeng.denoise_fn(state)(jnp.asarray(x), jnp.asarray(sig),
                                        jc)
    with torch.no_grad():
        got = teng.inv_denoise_fn()(torch.from_numpy(x),
                                    torch.from_numpy(sig), tc)
        got_d = teng.denoise_fn()(torch.from_numpy(x),
                                  torch.from_numpy(sig), tc)
    _check(got, want, "raw net out")
    _check(got_d, want_d, "denoiser")
    s = torch.from_numpy(sig).reshape(-1, 1, 1, 1)
    assert torch.allclose(got_d, torch.from_numpy(x) / (s ** 2 + 1)
                          - s / torch.sqrt(s ** 2 + 1) * got, atol=1e-5)


def _jax_noise(key, n_steps, blended):
    """JAX's initial noise and (blended) per-step renoise draws from
    ``key`` as ``SVDEngine.sample_blended``/``sample_inversion`` make
    them."""
    k1, k = jax.random.split(key)
    noise = np.array(jax.random.normal(k1, LAT))
    renoise = []
    for _ in range(n_steps):
        k, _, k2 = jax.random.split(k, 3)
        renoise.append(torch.from_numpy(np.array(jax.random.normal(k2,
                                                                   LAT))))
    return noise, (renoise if blended else None)


@pytest.mark.parametrize("mode", ["blended", "inversion"])
def test_blended_and_inversion_samples_match_jax(engines, mode):
    jeng, state, teng = engines
    (jc, juc), (tc, tuc) = _conds()
    z, mask = _bg()
    key = jax.random.key(64)
    inverted = []
    prev = jsamplers.set_latent_debug_hook(
        lambda tag, s, x: inverted.append(np.array(x))
        if tag == "invert" else None)
    try:
        with jax.disable_jit():
            noise, renoise = _jax_noise(key, STEPS, mode == "blended")
            fn = (jeng.sample_blended if mode == "blended"
                  else jeng.sample_inversion)
            want = np.asarray(fn(state, key, jc, juc, jnp.asarray(z),
                                 jnp.asarray(mask), num_steps=STEPS))
    finally:
        jsamplers.set_latent_debug_hook(prev)
    args = (tc, tuc, torch.from_numpy(z), torch.from_numpy(mask))
    kw = dict(noise=torch.from_numpy(noise), num_steps=STEPS)
    if mode == "blended":
        got = teng.sample_blended(*args, renoise=renoise, **kw)
    else:
        got = teng.sample_inversion(*args, **kw)
        assert len(inverted) == STEPS
    x0 = noise * np.sqrt(1 + np.float32(teng.cfg.sigma_max) ** 2)
    start = (x0 if mode == "blended"
             else mask * x0 + (1 - mask) * inverted[-1])
    _check(got, want, mode, bar=X0_ULPS * _spacing(start))
    # the sampled region moved off the background, the rest stayed near it
    out, inside = got.numpy(), mask > 0
    assert (np.abs(out - z)[inside].mean()
            > 10 * np.abs(out - z)[~inside].mean())


def _tree(tmp_path):
    root = str(tmp_path / "gs")
    synthetic.write_gs_tree(root, scene="toy_case", ctrl="ctrl_0",
                            modes=("x1",), frames=T, size=SIZE,
                            iteration=40)
    return root


@pytest.mark.parametrize("mode", ["blended", "inversion"])
def test_svd_test_cli_samples_blended_and_inversion(tmp_path, mode):
    """``svd_test --sampling blended|inversion --dump_latents``: the grid,
    the frames, one dump per sampler step (and per inversion step), their
    sigma ladder, and the last dump the sampled latents the frames
    decode."""
    root = _tree(tmp_path)
    dump, logdir = str(tmp_path / "dump"), str(tmp_path / "logs")
    svd_test.main(["--data_root", root, "--logdir", logdir, "--tiny_model",
                   "--num_frames", str(T), "--num_steps", str(STEPS),
                   "--size", str(SIZE[0]), str(SIZE[1]), "--iteration",
                   "40", "--modes", "x1", "--sampling", mode,
                   "--dump_latents", dump, "--device", "cpu"])
    assert len(os.listdir(os.path.join(logdir, "log_img", "test"))) == 1
    d = os.path.join(root, "inpainted", "toy_case", "ctrl_0", "x1")
    assert sorted(os.listdir(d)) == [f"{i:02d}.png" for i in range(T)]
    img = scene_io.load_image(os.path.join(d, "00.png"))
    assert img.shape == SIZE + (3,) and img.std() > 0
    tags = ([] if mode == "blended" else ["invert"] * STEPS) + (
        [mode] * STEPS)
    want = [f"latent_{i:03d}_{t}.npy" for i, t in enumerate(tags)]
    assert sorted(os.listdir(dump)) == sorted(want + ["latent_sigmas.npy"])
    ladder = torch.cat([tengine.edm.edm_sigmas(STEPS), torch.zeros(1)])
    sig = np.load(os.path.join(dump, "latent_sigmas.npy"))
    up = ([] if mode == "blended" else
          torch.flip(ladder, (0,))[1:].tolist())
    np.testing.assert_array_equal(sig, np.array(
        up + ladder[:-1].tolist(), np.float32))
    assert np.load(os.path.join(dump, want[-1])).shape == LAT
    assert tsamplers.set_latent_debug_hook(None) is None


def test_latent_mask_matches_jax_nearest_resize(tmp_path):
    """The CLI's latent mask: ``resize_nearest`` of the tree's masks to
    the latent grid, broadcast over the 4 channels, equal to
    ``jax.image.resize(masks, (t, h/8, w/8, 1), "nearest")``."""
    ds = GSVideoForwardDataset(_tree(tmp_path), size=SIZE, num_frames=T,
                               modes=("x1",), iteration=40)
    masks = ds[0]["masks"]
    assert masks.shape == (T,) + SIZE + (1,) and 0 < masks.mean() < 1
    got = resize_nearest(torch.from_numpy(masks)[..., 0], LAT[1:3])
    want = jax.image.resize(jnp.asarray(masks), LAT[:3] + (1,), "nearest")
    np.testing.assert_array_equal(got[..., None].expand(LAT).numpy(),
                                  np.broadcast_to(np.asarray(want), LAT))
