"""Port parity, the 2D diffusion networks of SDS and ``ctrl_inpaint``:
``diffusion/unet2d.UNet2D``, ``diffusion/controlnet2d.ControlNet2D`` and
the 2D VAE's weights, against the JAX package on the CPU in f32.

The networks are the tiny config of the JAX ``ctrl_inpaint --tiny`` test
(ch 32, one res block, attention at ds 1, mult (1, 2), heads of 16,
context 16) at an 8x8 latent (a 64x64 hint). The weights are the port's
seeded init with every leaf moved by a seeded N(0, 0.05^2) draw (so that
the zero-initialised output conv, ``proj_out`` and zero convs show),
carried to JAX by ``checkpoint.state_dict_to_jax``, whose leaves must be
exactly those of the JAX module's init (its shapes by ``jax.eval_shape``:
JAX's eager init of these networks takes ~50 s on one core), and back by
``state_dict_from_jax``, loaded strictly.

Bars:
- ``UNet2D`` eps (with and without ``control=``) and every ControlNet2D
  residual within 1e-4 of max|JAX| (f32 sums in another order over a few
  layers stay near 1e-6 of it);
- the reader (``checkpoint.import_state_dict``) on the carrier's torch
  state dicts: 0 missing and 0 unexpected for the UNet2D, the 2D VAE and
  the ControlNet2D, and the same leaves, bit for bit, as the JAX
  ``weights_io.import_unet(video=False)`` and ``import_vae(
  video_decoder=False)`` give (with 0 missing there too);
- ``SDSGuidance.train_step`` with these networks as its prior (CFG 7.5)
  and JAX's t and noise passed in: the loss within 1e-5 relative, the
  image gradient through the VAE encoder at the gradient bar 2e-6 + 1e-4
  max|g|;
- the JAX ``import_controlnet`` on the same ControlNet state dict leaves
  42 of the trunk's 102 leaves missing (every trunk ResBlock parameter:
  it maps the trunk through the video key space), which is why the port
  diverges from it on purpose.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from multiview_inpaint_tpu.diffusion import weights_io
from multiview_inpaint_tpu.diffusion.controlnet2d import \
    ControlNet2D as JControlNet2D
from multiview_inpaint_tpu.diffusion.unet2d import UNet2D as JUNet2D
from multiview_inpaint_tpu.diffusion.unet2d import \
    UNet2DConfig as JUNet2DConfig
from multiview_inpaint_tpu.diffusion.vae import AutoencoderKL as JVAE
from multiview_inpaint_tpu.diffusion.vae import VAEConfig as JVAEConfig
from multiview_inpaint_tpu.guidance import sds as jsds
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.diffusion.controlnet2d import ControlNet2D
from multiview_inpaint_tpu_torch.diffusion.unet2d import UNet2D, UNet2DConfig
from multiview_inpaint_tpu_torch.diffusion.vae import AutoencoderKL, VAEConfig
from multiview_inpaint_tpu_torch.guidance import sds as tsds

TINY = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(1,),
            channel_mult=(1, 2), num_head_channels=16, context_dim=16)
TINY_VAE = dict(ch=16, ch_mult=(1, 2, 4, 4), num_res_blocks=1)
B, S, SIZE, L = 2, 8, 64, 4
REL = 1e-4
UNET_PRE = checkpoint.PREFIXES["unet"]
CTRL_PRE = checkpoint.PREFIXES["controlnet"]
VAE_PRE = checkpoint.PREFIXES["vae"]


def perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    flat = flatten_dict(unfreeze(params), sep="/")
    return {k: (np.asarray(v, np.float32)
                + scale * rng.normal(size=np.shape(v))).astype(np.float32)
            for k, v in flat.items()}


def nested(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def check(got, want, what=""):
    got = got.detach().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bar = REL * float(np.abs(want).max())
    assert err <= bar, f"{what}: max abs err {err:.3g} > {bar:.3g}"


def _seeded(module, seed, scale=0.05):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen))
    return module


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in flatten_dict(
        unfreeze(tree), sep="/").items()}


@pytest.fixture(scope="module")
def nets():
    cfg = JUNet2DConfig(**TINY)
    key = jax.random.key(0)
    x = jnp.zeros((1, S, S, 9))
    t = jnp.zeros((1,))
    ctx = jnp.zeros((1, L, 16))
    templates = dict(
        unet=jax.eval_shape(JUNet2D(cfg).init, key, x, t, ctx)["params"],
        ctrl=jax.eval_shape(JControlNet2D(cfg).init, key, x,
                            jnp.zeros((1, SIZE, SIZE, 3)), t, ctx)["params"],
        vae=jax.eval_shape(JVAE(JVAEConfig(**TINY_VAE), video_decoder=False)
                           .init, key, jnp.zeros((1, 16, 16, 3)))["params"])
    torch.manual_seed(0)
    ports = dict(
        unet=(UNet2D(UNet2DConfig(**TINY)), UNET_PRE, "unet2d"),
        ctrl=(ControlNet2D(UNet2DConfig(**TINY)), CTRL_PRE, "controlnet2d"),
        vae=(AutoencoderKL(VAEConfig(**TINY_VAE), video_decoder=False),
             VAE_PRE, "vae2d"))
    out = dict(cfg=cfg, templates=templates)
    for i, (name, (module, pre, comp)) in enumerate(ports.items()):
        _seeded(module, i + 1)
        flat = checkpoint.state_dict_to_jax(
            {pre + k: v for k, v in module.state_dict().items()}, comp)
        assert {k: v.shape for k, v in flat.items()} == _shapes(
            templates[name]), name
        out[name] = flat
    return out


def _port(module, flat, component):
    pre = dict(unet2d=UNET_PRE, controlnet2d=CTRL_PRE, vae2d=VAE_PRE)[
        component]
    sd = checkpoint.state_dict_from_jax(flat, component)
    module.load_state_dict({k[len(pre):]: v for k, v in sd.items()},
                           strict=True)
    return module.eval().requires_grad_(False)


def _inputs():
    return (rand((B, S, S, 9), 10), np.array([17.0, 503.0], np.float32),
            rand((B, L, 16), 11), rand((B, SIZE, SIZE, 3), 12))


def test_controlnet2d_and_unet2d_match_jax(nets):
    x, t, ctx, hint = _inputs()
    jctrl = jax.jit(JControlNet2D(nets["cfg"]).apply)(
        {"params": nested(nets["ctrl"])}, jnp.asarray(x), jnp.asarray(hint),
        jnp.asarray(t), jnp.asarray(ctx))
    cnet = _port(ControlNet2D(UNet2DConfig(**TINY)), nets["ctrl"],
                 "controlnet2d")
    unet = _port(UNet2D(UNet2DConfig(**TINY)), nets["unet"], "unet2d")
    tt = [torch.from_numpy(a) for a in (x, t, ctx, hint)]
    with torch.no_grad():
        ctrl = cnet(tt[0], tt[3], tt[1], tt[2])
        assert len(ctrl) == len(jctrl) == 5
        for i, (a, b) in enumerate(zip(ctrl, jctrl)):
            check(a, b, f"control residual {i}")
        japply = jax.jit(JUNet2D(nets["cfg"]).apply)
        for control, jcontrol in ((None, None), (ctrl, jctrl)):
            want = japply({"params": nested(nets["unet"])}, jnp.asarray(x),
                          jnp.asarray(t), jnp.asarray(ctx), control=jcontrol)
            got = unet(tt[0], tt[1], tt[2], control=control)
            check(got, want, f"eps, control={control is not None}")
            assert float(np.abs(np.asarray(want)).max()) > 0.1


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("component", ["unet2d", "vae2d"])
def test_reader_matches_jax_importers(nets, component):
    name = "unet" if component == "unet2d" else "vae"
    flat, template = nets[name], nets["templates"][name]
    sd = checkpoint.state_dict_from_jax(flat, component)
    if component == "unet2d":
        module, pre = UNet2D(UNet2DConfig(**TINY)), UNET_PRE
        jparams, jm, ju = weights_io.import_unet(template, _numpy_sd(sd),
                                                 video=False)
    else:
        module, pre = AutoencoderKL(VAEConfig(**TINY_VAE),
                                    video_decoder=False), VAE_PRE
        jparams, jm, ju = weights_io.import_vae(template, _numpy_sd(sd),
                                                video_decoder=False)
    assert jm == [] and ju == []
    missing, unexpected = checkpoint.import_state_dict(module, sd, pre)
    assert missing == [] and unexpected == []
    back = checkpoint.state_dict_to_jax(
        {pre + k: v for k, v in module.state_dict().items()}, component)
    want = flatten_dict(unfreeze(jparams), sep="/")
    assert sorted(back) == sorted(want)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_reader_reports_missing_and_unexpected():
    module = UNet2D(UNet2DConfig(**TINY))
    sd = {UNET_PRE + k: v.clone() for k, v in module.state_dict().items()}
    sd.pop(UNET_PRE + "out.2.weight")
    sd[UNET_PRE + "out.2.bias"] = torch.zeros(5)
    sd[UNET_PRE + "no.such.key"] = torch.zeros(1)
    sd["other.prefix.weight"] = torch.zeros(1)
    missing, unexpected = checkpoint.import_state_dict(module, sd, UNET_PRE)
    assert missing == ["out.2.bias", "out.2.weight"]
    assert sorted(unexpected) == ["no.such.key",
                                  "out.2.bias shape (5,) vs (4,)"]


def test_controlnet2d_reader_loads_the_trunk_where_jax_drops_it(nets):
    flat = nets["ctrl"]
    sd = checkpoint.state_dict_from_jax(flat, "controlnet2d")
    cnet = ControlNet2D(UNet2DConfig(**TINY))
    missing, unexpected = checkpoint.import_state_dict(cnet, sd, CTRL_PRE)
    assert missing == [] and unexpected == []
    back = checkpoint.state_dict_to_jax(
        {CTRL_PRE + k: v for k, v in cnet.state_dict().items()},
        "controlnet2d")
    assert sorted(back) == sorted(flat)
    for k, v in back.items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    # The JAX importer on the same state dict: the trunk's ResBlock leaves
    # come back missing (and their video-space keys unexpected).
    _, jm, ju = weights_io.import_controlnet(nets["templates"]["ctrl"],
                                             _numpy_sd(sd))
    trunk = [k for k in flat if k.startswith("trunk/")]
    resblock = [k for k in trunk
                if any(p in k for p in ("in_layers", "emb_layers",
                                        "out_layers", "skip_connection"))]
    assert (len(trunk), len(resblock)) == (102, 42)
    assert sorted(jm) == sorted(resblock)
    assert len(ju) == 42 and all("/spatial/" in k for k in ju)


def test_sds_train_step_through_unet2d_and_vae_matches_jax(nets):
    up, vp = nested(nets["unet"]), nested(nets["vae"])
    junet = JUNet2D(nets["cfg"])
    jvae = JVAE(JVAEConfig(**TINY_VAE), video_decoder=False)
    jg = jsds.SDSGuidance(
        lambda x9, t, e: junet.apply({"params": up}, x9, t, e),
        lambda im: jvae.apply({"params": vp}, im * 2 - 1,
                              method=JVAE.encode).mode() * 0.18215,
        None, jsds.SDSConfig(guidance_scale=7.5))
    unet = _port(UNet2D(UNet2DConfig(**TINY)), nets["unet"], "unet2d")
    vae = _port(AutoencoderKL(VAEConfig(**TINY_VAE), video_decoder=False),
                nets["vae"], "vae2d")
    tg = tsds.SDSGuidance(
        lambda x9, t, e: unet(x9, t, e),
        lambda im: vae.encode(im * 2 - 1).mode() * 0.18215, None,
        tsds.SDSConfig(guidance_scale=7.5))
    rng = np.random.default_rng(4)
    img = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((SIZE, SIZE), np.float32)
    mask[16:48, 20:52] = 1.0
    text = rng.normal(size=(2, L, 16)).astype(np.float32)
    key = jax.random.key(5)
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda im: jg.train_step(key, im, jnp.asarray(mask),
                                 jnp.asarray(text))))(jnp.asarray(img))
    k1, k2 = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(k1, (1,), 20, 981)))
    noise = torch.from_numpy(np.array(jax.random.normal(k2, (1, S, S, 4))))
    x = torch.from_numpy(img).requires_grad_(True)
    loss_t = tg.train_step(x, torch.from_numpy(mask), torch.from_numpy(text),
                           t=t.long(), noise=noise)
    (g_t,) = torch.autograd.grad(loss_t, x)
    loss_t, loss_j, g_j = float(loss_t.detach()), float(loss_j), np.asarray(
        g_j)
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(g_t.numpy(), g_j,
                               atol=2e-6 + 1e-4 * np.abs(g_j).max())
