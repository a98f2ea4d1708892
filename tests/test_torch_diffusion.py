"""Port parity, diffusion modules: each module of
``multiview_inpaint_tpu_torch/diffusion`` against its JAX counterpart on
the CPU in f32.

The same numpy inputs go through both; the JAX module's parameters, every
leaf moved by a seeded N(0, 0.05^2) draw (so the zero-initialised output
convs and projections, which would hide a mis-wired block, are non-zero),
are carried into the port through ``checkpoint.state_dict_from_jax`` and
loaded strictly. Bars are stated per test as an absolute error relative
to the largest output magnitude: f32 sums taken in another order, and
different exp/tanh/erf code, over a few layers, stay below 1e-5 of it
(5e-5 for the whole UNet and the VAE, which stack more layers).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from multiview_inpaint_tpu.diffusion import clip_vit as jclip
from multiview_inpaint_tpu.diffusion import conditioners as jcond
from multiview_inpaint_tpu.diffusion import controlnet as jcontrolnet
from multiview_inpaint_tpu.diffusion import layers as jlayers
from multiview_inpaint_tpu.diffusion import resblock as jresblock
from multiview_inpaint_tpu.diffusion import transformer as jtransformer
from multiview_inpaint_tpu.diffusion import unet as junet
from multiview_inpaint_tpu.diffusion import vae as jvae
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.diffusion import clip_vit as tclip
from multiview_inpaint_tpu_torch.diffusion import conditioners as tcond
from multiview_inpaint_tpu_torch.diffusion import controlnet as tcontrolnet
from multiview_inpaint_tpu_torch.diffusion import layers as tlayers
from multiview_inpaint_tpu_torch.diffusion import resblock as tresblock
from multiview_inpaint_tpu_torch.diffusion import transformer as ttransformer
from multiview_inpaint_tpu_torch.diffusion import unet as tunet
from multiview_inpaint_tpu_torch.diffusion import vae as tvae

T = 3            # frames
CTX = 16         # context width
ADM = 24         # vector width


def perturb(params, seed=0, scale=0.05):
    """Flat ``{"a/b": f32 ndarray}`` of a flax tree, each leaf moved by a
    seeded N(0, scale^2) draw."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(unfreeze(params), sep="/")
    return {k: (np.asarray(v, np.float32)
                + scale * rng.normal(size=np.shape(v))).astype(np.float32)
            for k, v in flat.items()}


def nested(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def carry(module, flat, component="unet"):
    """Load JAX params into a port module through the carrier, strictly."""
    pre = checkpoint.PREFIXES[component]
    sd = checkpoint.state_dict_from_jax(flat, component)
    module.load_state_dict({k[len(pre):]: v for k, v in sd.items()},
                           strict=True)
    return module.eval().requires_grad_(False)


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def check(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bar = rel * max(float(np.abs(want).max()), 1e-6)
    assert err <= bar, f"{what}: max abs err {err:.3g} > {bar:.3g}"


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


TINY_UNET = dict(model_channels=32, num_res_blocks=1,
                 attention_resolutions=(1, 2), channel_mult=(1, 2),
                 num_head_channels=16, context_dim=CTX, adm_in_channels=ADM)


# ---------------------------------------------------------------- layers
def test_timestep_embedding_matches_jax():
    # c_noise = log(sigma) / 4 in [-1.6, 1.7]; frame indices 0 ... 13
    t = np.array([0.0, 1.5, 13.0, -1.55, 1.64], np.float32)
    for dim in (32, 33, 320):
        check(tlayers.timestep_embedding(torch.from_numpy(t), dim),
              jlayers.timestep_embedding(jnp.asarray(t), dim), 1e-5, dim)


def test_groupnorm32_runs_in_f32_and_matches_jax():
    x = rand((2, 5, 4, 64), 1, 3.0)
    jm = jlayers.GroupNorm32()
    flat = perturb(jm.init(jax.random.key(0), jnp.asarray(x))["params"], 1)
    want = jm.apply({"params": nested(flat)}, jnp.asarray(x))
    gn = tlayers.GroupNorm32(64)
    gn.load_state_dict({"weight": torch.from_numpy(flat["norm/scale"]),
                        "bias": torch.from_numpy(flat["norm/bias"])})
    with torch.no_grad():
        check(nhwc(gn(nchw(x))), want, 1e-5)
        half = gn.to(torch.bfloat16)(nchw(x).to(torch.bfloat16))
    assert half.dtype == torch.bfloat16
    assert gn.num_groups == 32 and tlayers.GroupNorm32(16).num_groups == 16


@pytest.mark.parametrize("strategy", ["learned_with_images", "learned",
                                      "fixed"])
def test_alpha_blender_matches_jax(strategy):
    xs, xt = rand((4, 3, 2, 5), 2), rand((4, 3, 2, 5), 3)
    ind = np.array([[0, 1], [0, 0]], np.float32)
    jm = jlayers.AlphaBlender(merge_strategy=strategy)
    args = (jnp.asarray(xs), jnp.asarray(xt), jnp.asarray(ind))
    variables = jm.init(jax.random.key(0), *args)
    tm = tlayers.AlphaBlender(merge_strategy=strategy)
    if strategy != "fixed":
        flat = perturb(variables["params"], 4, 0.7)
        variables = {"params": nested(flat)}
        tm.mix_factor.data = torch.from_numpy(flat["mix_factor"])
    check(tm(torch.from_numpy(xs), torch.from_numpy(xt),
             torch.from_numpy(ind)), jm.apply(variables, *args), 1e-6)


@pytest.mark.parametrize("kind", ["up", "down"])
def test_up_and_downsample_match_jax(kind):
    x = rand((2, 6, 4, 8), 5)
    jm = (jlayers.Upsample(12) if kind == "up" else jlayers.Downsample(12))
    flat = perturb(jm.init(jax.random.key(0), jnp.asarray(x))["params"], 5)
    tm = carry(tlayers.Upsample(8, 12) if kind == "up"
               else tlayers.Downsample(8, 12), flat)
    want = jm.apply({"params": nested(flat)}, jnp.asarray(x))
    check(nhwc(tm(nchw(x))), want, 1e-5)


# ---------------------------------------------------------- res + attention
def test_video_resblock_matches_jax():
    x, emb = rand((2 * T, 6, 4, 32), 6), rand((2 * T, 40), 7)
    ind = np.zeros((2, T), np.float32)
    jm = jresblock.VideoResBlock(64)
    args = (jnp.asarray(x), jnp.asarray(emb), T, jnp.asarray(ind))
    flat = perturb(jm.init(jax.random.key(0), *args)["params"], 6)
    tm = carry(tresblock.VideoResBlock(32, 40, 64), flat)
    want = jm.apply({"params": nested(flat)}, *args)
    got = tm(nchw(x), torch.from_numpy(emb), T, torch.from_numpy(ind))
    check(nhwc(got), want, 1e-5)


def test_spatial_video_transformer_matches_jax():
    x, ctx = rand((2 * T, 4, 6, 32), 8), rand((2 * T, 1, CTX), 9)
    ind = np.zeros((2, T), np.float32)
    jm = jtransformer.SpatialVideoTransformer(32, 2, 16, context_dim=CTX)
    args = (jnp.asarray(x), jnp.asarray(ctx), T, jnp.asarray(ind))
    flat = perturb(jm.init(jax.random.key(0), *args)["params"], 8)
    tm = carry(ttransformer.SpatialVideoTransformer(32, 2, 16,
                                                    context_dim=CTX), flat)
    want = jm.apply({"params": nested(flat)}, *args)
    got = tm(nchw(x), torch.from_numpy(ctx), T, torch.from_numpy(ind))
    check(nhwc(got), want, 1e-5)


def _unet_inputs(cfg_in=8, h=8, w=6, seed=10):
    return (rand((2 * T, h, w, cfg_in), seed),
            np.linspace(-1.0, 2.0, 2 * T).astype(np.float32),
            rand((2 * T, 1, CTX), seed + 1), rand((2 * T, ADM), seed + 2),
            np.zeros((2, T), np.float32))


def test_tiny_video_unet_with_control_matches_jax():
    cfg = junet.UNetConfig(**TINY_UNET)
    x, ts, ctx, y, ind = _unet_inputs()
    jm = junet.VideoUNet(cfg)
    args = tuple(jnp.asarray(a) for a in (x, ts, ctx, y))
    flat = perturb(jm.init(jax.random.key(0), *args, num_video_frames=T,
                           image_only_indicator=jnp.asarray(ind))["params"],
                   10)
    tm = carry(tunet.VideoUNet(tunet.UNetConfig(**TINY_UNET)), flat)
    targs = tuple(torch.from_numpy(a) for a in (x, ts, ctx, y))
    with torch.no_grad():
        feats = tm(*targs, num_video_frames=T,
                   image_only_indicator=torch.from_numpy(ind),
                   extract_features=True)
    control = [rand(tuple(f.shape), 20 + i, 0.3)
               for i, f in enumerate(feats)]
    want = jm.apply({"params": nested(flat)}, *args, num_video_frames=T,
                    image_only_indicator=jnp.asarray(ind),
                    control=[jnp.asarray(c) for c in control])
    with torch.no_grad():
        got = tm(*targs, num_video_frames=T,
                 image_only_indicator=torch.from_numpy(ind),
                 control=[torch.from_numpy(c) for c in control])
        plain = tm(*targs, num_video_frames=T,
                   image_only_indicator=torch.from_numpy(ind))
    check(got, want, 5e-5, "unet with control")
    # the residuals do reach the output
    assert float((got - plain).abs().max()) > 1e-3


def test_controlnet_matches_jax():
    cfg = junet.UNetConfig(**TINY_UNET)
    x, ts, ctx, y, ind = _unet_inputs(seed=30)
    hint = rand((2 * T, 64, 48, 7), 33)
    jm = jcontrolnet.ControlNet(cfg, 7)
    args = tuple(jnp.asarray(a) for a in (x, hint, ts, ctx, y))
    flat = perturb(jm.init(jax.random.key(0), *args, num_video_frames=T,
                           image_only_indicator=jnp.asarray(ind))["params"],
                   30)
    tm = carry(tcontrolnet.ControlNet(tunet.UNetConfig(**TINY_UNET), 7),
               flat, "controlnet")
    want = jm.apply({"params": nested(flat)}, *args, num_video_frames=T,
                    image_only_indicator=jnp.asarray(ind))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (x, hint, ts, ctx, y)),
                 num_video_frames=T,
                 image_only_indicator=torch.from_numpy(ind))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        check(g, w, 2e-5, f"residual {i}")


# ------------------------------------------------------------------- VAE
VAE_CFG = dict(ch=16, ch_mult=(1, 2, 4, 4), num_res_blocks=1)


@pytest.fixture(scope="module")
def vae_pair():
    jm = jvae.AutoencoderKL(jvae.VAEConfig(**VAE_CFG))
    flat = perturb(jm.init(jax.random.key(0),
                           jnp.zeros((T, 32, 24, 3)))["params"], 40)
    tm = carry(tvae.AutoencoderKL(tvae.VAEConfig(**VAE_CFG)), flat, "vae")
    return jm, nested(flat), tm


def test_vae_encode_matches_jax(vae_pair):
    jm, params, tm = vae_pair
    x = np.clip(rand((2, 32, 24, 3), 41, 0.5), -1, 1)
    post = jm.apply({"params": params}, jnp.asarray(x),
                    method=jvae.AutoencoderKL.encode)
    noise = rand(post.mean.shape, 42)
    with torch.no_grad():
        tpost = tm.encode(torch.from_numpy(x))
        check(tpost.mode(), post.mode(), 5e-5, "mean")
        check(tpost.logvar, post.logvar, 5e-5, "logvar")
        check(tpost.sample(torch.from_numpy(noise)),
              post.mean + post.std * noise, 5e-5, "sample")


def test_vae_video_decode_matches_jax(vae_pair):
    jm, params, tm = vae_pair
    z = rand((2 * T, 4, 3, 4), 43)
    want = jm.apply({"params": params}, jnp.asarray(z), T,
                    method=jvae.AutoencoderKL.decode)
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z), T)
        single = tm.decode(torch.from_numpy(z), 1)
    check(got, want, 5e-5, "decode")
    # the temporal layers act: frames decoded alone differ
    assert float((got - single).abs().max()) > 1e-4


# ------------------------------------------------------------- CLIP, cond
@pytest.fixture(scope="module")
def clip_pair():
    cfg = dataclasses.replace(jclip.TINY_VIT, output_dim=CTX)
    jm = jclip.CLIPVisionTower(cfg)
    flat = perturb(jm.init(jax.random.key(0),
                           jnp.zeros((1, 64, 48, 3)))["params"], 50)
    tm = carry(tclip.CLIPVisionTower(dataclasses.replace(
        tclip.TINY_VIT, output_dim=CTX)), flat, "clip")
    return jm, nested(flat), tm


@pytest.mark.parametrize("hw", [(64, 48), (300, 260)])
def test_bicubic_resize_matches_jax_image_resize(hw):
    """Against JAX at 2e-5 of max|out|: XLA's own f32 contraction is off
    an f64 evaluation of the same weights by up to 1.3e-5 of it when
    downsampling; the port holds the f64 evaluation at 1e-6."""
    x = rand((2,) + hw + (3,), 51)
    want = jax.image.resize(jnp.asarray(x), (2, 224, 224, 3), "bicubic")
    got = tclip.resize_bicubic(torch.from_numpy(x), (224, 224))
    check(got, want, 2e-5)
    exact = torch.einsum("bhwc,hi,wj->bijc", torch.from_numpy(x).double(),
                         *(tclip._resize_weights(n, 224, "cpu").double()
                           for n in hw))
    check(got, exact.float(), 1e-6)


def test_tiny_clip_tower_matches_jax(clip_pair):
    jm, params, tm = clip_pair
    x = np.clip(rand((2, 64, 48, 3), 52, 0.5), -1, 1)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    check(got, jm.apply({"params": params}, jnp.asarray(x)), 2e-5)


def test_conditioner_matches_jax(clip_pair, vae_pair):
    jclip_m, clip_params, tclip_m = clip_pair
    jvae_m, vae_params, tvae_m = vae_pair
    frames = np.clip(rand((1, 32, 24, 3), 60, 0.5), -1, 1)
    batch = {"cond_frames_without_noise": frames, "cond_frames": frames,
             "fps_id": np.array([6.0], np.float32),
             "motion_bucket_id": np.array([127.0], np.float32),
             "cond_aug": np.array([0.02], np.float32)}
    jc = jcond.Conditioner(
        clip_embed=lambda f: jclip_m.apply({"params": clip_params}, f),
        vae_encode_mode=lambda f: jvae_m.apply(
            {"params": vae_params}, f,
            method=jvae.AutoencoderKL.encode).mode())
    tc = tcond.Conditioner(
        clip_embed=lambda f: tclip_m(f),
        vae_encode_mode=lambda f: tvae_m.encode(f).mode())
    key = jax.random.key(3)
    noise = np.array(jax.random.normal(key, frames.shape, jnp.float32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for force_zero in (False, True):
        want = jc(jbatch, force_zero=force_zero, key=key)
        with torch.no_grad():
            got = tc(tbatch, force_zero=force_zero,
                     aug_noise=torch.from_numpy(noise))
        assert set(got) == set(want)
        for k in want:   # the vector's fourier args reach 127
            check(got[k], want[k], 1e-5 if k == "vector" else 5e-5, k)
    per_frame = tcond.repeat_cond_per_frame(
        {k: v for k, v in got.items()}, T, ("crossattn", "concat", "vector"))
    want_pf = jcond.repeat_cond_per_frame(want, T,
                                          ("crossattn", "concat", "vector"))
    for k in want_pf:
        check(per_frame[k], want_pf[k], 1e-5, k)
    check(tcond.fourier_scalar_embed(torch.tensor([[1.0, 2.0]]), 8),
          jcond.fourier_scalar_embed(jnp.array([[1.0, 2.0]]), 8), 1e-6)
