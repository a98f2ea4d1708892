"""Port parity, slice 9b's losses and layers: ``diffusion/autoencoder_loss``
(the PatchGAN discriminator, hinge and vanilla losses, the generator and
discriminator objectives), ``diffusion/regularizers`` and the VAE's
``VideoAttnBlock`` and decoder ``time_mode``s, against the JAX package on
the CPU in f32.

The port modules start from their seeded init with every leaf moved by a
seeded N(0, 0.05^2) draw (so that zero-initialised leaves, ``mix_factor``
and the GroupNorm biases show); the weights go to JAX through the port's
carriers (``checkpoint.torch_to_flax``, ``state_dict_to_jax``), whose
leaves must be exactly those of the JAX module's init (its shapes by
``jax.eval_shape``).

Bars:
- the discriminator's logits (all three norms, train and eval mode) and
  its running statistics after a train-mode call: within 1e-5 of
  max|JAX|; the output size [B, H/8 - 2, W/8 - 2, 1];
- hinge and vanilla: 1e-6 relative;
- ``generator_loss`` and ``discriminator_loss`` below and above
  ``disc_start`` (an analytic perceptual term, learned logvar 0.3): the
  real and fake patch logits within 1e-5 of max|JAX|, every log entry
  within 1e-5 relative (exact zeros exactly) except the means of the
  logits (``logits/real``, ``logits/fake``, ``loss/g``), held within
  1e-5 of the mean |logit| (the port's init draws from torch's global
  generator, so the weights differ run to run, and a mean near 0 has no
  relative accuracy to hold), the gradients of
  the generator loss with respect to ``recon`` and ``logvar`` and of the
  discriminator loss with respect to its parameters at the gradient bar
  2e-6 + 1e-4 max|g|;
- the regularizers: the KL sample with JAX's draw within 1e-6 relative,
  the VQ indices exactly equal (a duplicated code included: both take
  the first), its loss, perplexity and straight-through gradients within
  1e-5 relative, two EMA codebook updates within 1e-5 relative;
- ``VideoAttnBlock`` (mix_factor off 0) and a tiny ``Decoder`` in every
  time mode within 1e-5 of max|JAX|; the reference torch keys of both
  load every leaf (0 missing, 0 unexpected) and map back to the JAX
  leaves.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from multiview_inpaint_tpu.diffusion import autoencoder_loss as jal
from multiview_inpaint_tpu.diffusion import regularizers as jreg
from multiview_inpaint_tpu.diffusion import vae as jvae
from multiview_inpaint_tpu_torch.diffusion import autoencoder_loss as tal
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.diffusion import regularizers as treg
from multiview_inpaint_tpu_torch.diffusion import vae as tvae

REL = 1e-5
VAE_PRE = checkpoint.PREFIXES["vae"]


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _seeded(module, seed, scale=0.05):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen))
    return module


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in flatten_dict(
        unfreeze(tree), sep="/").items()}


def nested(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bar = rel * float(np.abs(want).max())
    assert err <= bar, f"{what}: max abs err {err:.3g} > {bar:.3g}"


def grad_close(got, want, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    bar = 2e-6 + 1e-4 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bar, f"{what}: gradient err {err:.3g} > {bar:.3g}"


# --- the discriminator -------------------------------------------------------

def _disc_pair(norm, ndf=16, n_layers=3, seed=1):
    port = _seeded(tal.PatchDiscriminator(ndf, n_layers, norm), seed)
    x0 = jnp.zeros((2, 64, 64, 3))
    jd = jal.PatchDiscriminator(ndf=ndf, n_layers=n_layers, norm=norm)
    shapes = jax.eval_shape(lambda k, x: jd.init(k, x, train=False),
                            jax.random.key(0), x0)
    params = checkpoint.torch_to_flax(dict(port.named_parameters()))
    assert {k: v.shape for k, v in params.items()} == _shapes(
        shapes["params"])
    variables = {"params": nested(params)}
    if norm == "batch":
        rng = np.random.default_rng(seed)
        stats = {}
        for i in range(1, n_layers + 1):
            bn = getattr(port, f"norm_{i}")
            c = bn.num_features
            bn.running_mean.copy_(torch.from_numpy(rand((c,), seed + i, 0.1)))
            bn.running_var.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, c).astype(np.float32)))
            stats[f"norm_{i}/mean"] = bn.running_mean.numpy().copy()
            stats[f"norm_{i}/var"] = bn.running_var.numpy().copy()
        assert set(stats) == set(_shapes(shapes["batch_stats"]))
        variables["batch_stats"] = nested(stats)
    return port, jd, variables


@pytest.mark.parametrize("norm", ["group", "batch", None])
def test_patch_discriminator_matches_jax(norm):
    port, jd, variables = _disc_pair(norm)
    x = rand((2, 64, 64, 3), 3)
    want_eval = jd.apply(variables, jnp.asarray(x), train=False)
    port.eval()
    got_eval = port(torch.from_numpy(x))
    assert tuple(got_eval.shape) == (2, 64 // 8 - 2, 64 // 8 - 2, 1)
    close(got_eval, want_eval, what=f"{norm} eval")
    port.train()
    if norm == "batch":
        want, upd = jd.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        got = port(torch.from_numpy(x))
        for k, v in flatten_dict(unfreeze(upd["batch_stats"]),
                                 sep="/").items():
            name, stat = k.split("/")
            buf = getattr(port, name).running_mean if stat == "mean" else \
                getattr(port, name).running_var
            close(buf, v, what=k)
    else:
        want = jd.apply(variables, jnp.asarray(x), train=True)
        got = port(torch.from_numpy(x))
    close(got, want, what=f"{norm} train")


@pytest.mark.parametrize("fn", ["hinge_d_loss", "vanilla_d_loss"])
def test_d_losses_match_jax(fn):
    real, fake = rand((3, 5, 5, 1), 4), rand((3, 5, 5, 1), 5)
    want = float(getattr(jal, fn)(jnp.asarray(real), jnp.asarray(fake)))
    got = float(getattr(tal, fn)(torch.from_numpy(real),
                                 torch.from_numpy(fake)))
    assert abs(got - want) <= 1e-6 * abs(want)


# an analytic stand-in for LPIPS: a channel-weighted mean square per item
_PW = np.linspace(0.5, 1.5, 3).astype(np.float32)


def _jperceptual(a, b):
    return jnp.mean((a - b) ** 2 * _PW, axis=(1, 2, 3))


def _tperceptual(a, b):
    return torch.mean((a - b) ** 2 * torch.from_numpy(_PW), dim=(1, 2, 3))


@pytest.mark.parametrize("disc_loss", ["hinge", "vanilla"])
@pytest.mark.parametrize("step", [2, 7])
def test_generator_and_discriminator_losses_match_jax(step, disc_loss):
    port, jd, variables = _disc_pair("group", ndf=32, n_layers=1, seed=6)
    cfg = dict(disc_start=5, disc_weight=0.5, perceptual_weight=0.7,
               disc_loss=disc_loss, learn_logvar=True,
               regularization_weights=(("kl_loss", 1e-3),))
    jcfg, tcfg = jal.GANLossConfig(**cfg), tal.GANLossConfig(**cfg)
    inputs = np.tanh(rand((2, 32, 32, 3), 7))
    recon = np.tanh(rand((2, 32, 32, 3), 8))
    kl = np.abs(rand((2,), 9)) * 50
    logvar = np.float32(0.3)

    def jdisc(p):
        return lambda img: jd.apply({"params": p}, img)

    def jgen(r, lv):
        return jal.generator_loss(
            jdisc(variables["params"]), jnp.asarray(inputs), r, lv, step,
            jcfg, lpips_fn=_jperceptual,
            regularization_log={"kl_loss": jnp.asarray(kl)})

    (_, jlog), (jg_r, jg_lv) = jax.value_and_grad(
        jgen, argnums=(0, 1), has_aux=True)(jnp.asarray(recon),
                                            jnp.asarray(logvar))
    r = torch.from_numpy(recon).requires_grad_(True)
    lv = torch.tensor(logvar, requires_grad=True)
    loss, tlog = tal.generator_loss(
        port, torch.from_numpy(inputs), r, lv, step, tcfg,
        lpips_fn=_tperceptual,
        regularization_log={"kl_loss": torch.from_numpy(kl)})
    tg_r, tg_lv = torch.autograd.grad(loss, [r, lv])

    def jdl(p):
        return jal.discriminator_loss(jdisc(p), jnp.asarray(inputs),
                                      jnp.asarray(recon), step, jcfg)

    (_, jdlog), jdg = jax.value_and_grad(jdl, has_aux=True)(
        variables["params"])
    d_loss, tdlog = tal.discriminator_loss(
        port, torch.from_numpy(inputs), r, step, tcfg)
    names = list(dict(port.named_parameters()))
    tdg = dict(zip(names, torch.autograd.grad(
        d_loss, list(port.parameters()))))

    # The patch logits element by element; the log entries that are a
    # mean of them are held at REL of the mean |logit|, the scale of the
    # per-element rounding (a mean near 0 has no relative accuracy).
    logit_scale = {}
    for name, x in (("real", inputs), ("fake", recon)):
        want_l = jdisc(variables["params"])(jnp.asarray(x))
        with torch.no_grad():
            close(port(torch.from_numpy(x)), want_l, what=f"logits {name}")
        logit_scale[f"logits/{name}"] = float(jnp.mean(jnp.abs(want_l)))
    logit_scale["loss/g"] = logit_scale["logits/fake"]
    assert set(tlog) == set(jlog) and set(tdlog) == set(jdlog)
    for k in list(jlog) + list(jdlog):
        want = float({**jlog, **jdlog}[k])
        got = float({**tlog, **tdlog}[k].detach())
        scale = logit_scale.get(k, abs(want))
        assert abs(got - want) <= REL * scale, (k, got, want, scale)
    if step < cfg["disc_start"]:
        assert float(tdlog["loss/disc"]) == 0.0
    else:
        assert float(tdlog["loss/disc"]) != 0.0
    grad_close(tg_r, jg_r, "d loss / d recon")
    grad_close(tg_lv, jg_lv, "d loss / d logvar")
    jflat = checkpoint.torch_to_flax(tdg)
    for k, v in flatten_dict(unfreeze(jdg), sep="/").items():
        grad_close(torch.from_numpy(jflat[k]), v, k)


# --- the regularizers --------------------------------------------------------

def test_diagonal_gaussian_regularizer_matches_jax():
    z_params = rand((2, 6, 5, 8), 10)
    key = jax.random.key(3)
    jz, jlog = jreg.diagonal_gaussian_regularizer(jnp.asarray(z_params),
                                                  key)
    noise = jax.random.normal(key, (2, 6, 5, 4), jnp.float32)
    tz, tlog = treg.diagonal_gaussian_regularizer(
        torch.from_numpy(z_params), torch.from_numpy(np.array(noise)))
    close(tz, jz, 1e-6, "z")
    assert abs(float(tlog["kl_loss"]) - float(jlog["kl_loss"])) <= \
        1e-6 * abs(float(jlog["kl_loss"]))
    jm, jm_log = jreg.diagonal_gaussian_regularizer(
        jnp.asarray(z_params), sample=False)
    tm, tm_log = treg.diagonal_gaussian_regularizer(
        torch.from_numpy(z_params), sample=False)
    close(tm, jm, 0.0, "mode")


def test_vector_quantizer_matches_jax():
    n_codes, dim = 24, 4
    port = treg.VectorQuantizer(n_codes, dim, beta=0.25)
    with torch.no_grad():
        port.codebook.copy_(torch.from_numpy(rand((n_codes, dim), 11, 0.5)))
        port.codebook[7] = port.codebook[3]      # a tie: the first wins
    z = rand((2, 5, 5, dim), 12, 0.5)
    z[0, 0, 0] = port.codebook[3].detach().numpy()
    jq = jreg.VectorQuantizer(n_codes=n_codes, dim=dim, beta=0.25)
    shapes = jax.eval_shape(jq.init, jax.random.key(0), jnp.asarray(z))
    params = {"codebook": jnp.asarray(port.codebook.detach().numpy())}
    assert _shapes(shapes["params"]) == {"codebook": (n_codes, dim)}
    w = rand(z.shape, 13)

    def jloss(zz, cb):
        z_st, log = jq.apply({"params": {"codebook": cb}}, zz)
        return jnp.sum(z_st * w) + log["vq_loss"], log

    (_, jlog), (jgz, jgc) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(z),
                                             params["codebook"])
    zt = torch.from_numpy(z).requires_grad_(True)
    z_st, tlog = port(zt)
    loss = torch.sum(z_st * torch.from_numpy(w)) + tlog["vq_loss"]
    tgz, tgc = torch.autograd.grad(loss, [zt, port.codebook])
    assert np.array_equal(tlog["indices"].numpy(),
                          np.asarray(jlog["indices"]))
    assert int(tlog["indices"][0]) == 3
    for k in ("vq_loss", "perplexity"):
        assert abs(float(tlog[k]) - float(jlog[k])) <= \
            REL * abs(float(jlog[k])), k
    close(tgz, jgz, REL, "d/dz")
    close(tgc, jgc, REL, "d/dcodebook")


def test_ema_codebook_matches_jax():
    n_codes, dim = 16, 3
    key = jax.random.key(5)
    jstate = jreg.init_ema_codebook(key, n_codes, dim)
    tstate = treg.init_ema_codebook(n_codes, dim, codebook=torch.from_numpy(
        np.asarray(jstate["codebook"])))
    for it in range(2):
        z = rand((4, 6, dim), 20 + it)
        jz, jlog = jreg.ema_quantize(jstate, jnp.asarray(z))
        tz, tlog = treg.ema_quantize(tstate, torch.from_numpy(z))
        assert np.array_equal(tlog["indices"].numpy(),
                              np.asarray(jlog["indices"]))
        close(tz, jz, REL, "z_q")
        assert abs(float(tlog["vq_loss"]) - float(jlog["vq_loss"])) <= \
            REL * abs(float(jlog["vq_loss"]))
        jstate = jreg.ema_codebook_update(jstate, jnp.asarray(z))
        tstate = treg.ema_codebook_update(tstate, torch.from_numpy(z))
        for k in ("codebook", "cluster_size", "embed_avg"):
            close(tstate[k], jstate[k], REL, k)


# --- VideoAttnBlock and the decoder's time modes -----------------------------

def _carry_vae(jflat, module, prefix):
    """JAX VAE leaves (``decoder/...``) -> the reference torch keys ->
    ``module``: every leaf loads."""
    sd = checkpoint.state_dict_from_jax(
        {"vae/" + k: v for k, v in jflat.items()})
    missing, unexpected = checkpoint.import_state_dict(module, sd, prefix)
    assert missing == [] and unexpected == [], (missing, unexpected)
    return sd


def test_video_attn_block_matches_jax():
    b, t, hh, ww, c = 1, 3, 4, 3, 32
    x = rand((b * t, hh, ww, c), 30)
    jb = jvae.VideoAttnBlock()
    shapes = jax.eval_shape(lambda k, xx: jb.init(k, xx, t),
                            jax.random.key(0), jnp.asarray(x))
    port = _seeded(tvae.VideoAttnBlock(c), 31)
    with torch.no_grad():
        port.mix_factor.fill_(0.7)
    pre = VAE_PRE + "decoder.mid.attn_1."
    flat = {k[len("decoder/mid_attn_1/"):]: v for k, v in
            checkpoint.state_dict_to_jax(
                {pre + k: v for k, v in port.state_dict().items()},
                "vae").items()}
    assert {k: v.shape for k, v in flat.items()} == _shapes(
        shapes["params"])
    want = jb.apply({"params": nested(flat)}, jnp.asarray(x), t)
    fresh = tvae.VideoAttnBlock(c)
    _carry_vae({"decoder/mid_attn_1/" + k: v for k, v in flat.items()},
               fresh, pre)
    got = fresh(torch.from_numpy(x).permute(0, 3, 1, 2), t).permute(
        0, 2, 3, 1)
    close(got, want, REL, "VideoAttnBlock")


@pytest.mark.parametrize("time_mode", ["conv-only", "all", "attn-only",
                                       "only-last-conv"])
def test_decoder_time_modes_match_jax(time_mode):
    cfg = dict(ch=32, ch_mult=(1,), num_res_blocks=1, z_channels=4)
    t = 3
    z = rand((1 * t, 4, 3, 4), 40)
    jd = jvae.Decoder(jvae.VAEConfig(**cfg), video=True, time_mode=time_mode)
    shapes = jax.eval_shape(lambda k, zz: jd.init(k, zz, t),
                            jax.random.key(0), jnp.asarray(z))
    port = _seeded(tvae.Decoder(tvae.VAEConfig(**cfg), video=True,
                                time_mode=time_mode), 41)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if name.endswith("mix_factor"):
                p.fill_(-0.6)
    # the JAX map nests ResnetBlock parameters under "spatial" only where
    # the decoder's ResnetBlocks are temporal
    comp = "vae" if time_mode in ("conv-only", "all") else "vae2d"
    pre = VAE_PRE + "decoder."
    flat = {k[len("decoder/"):]: v for k, v in checkpoint.state_dict_to_jax(
        {pre + k: v for k, v in port.state_dict().items()}, comp).items()}
    assert {k: v.shape for k, v in flat.items()} == _shapes(
        shapes["params"])
    want = jd.apply({"params": nested(flat)}, jnp.asarray(z), t)
    fresh = tvae.Decoder(tvae.VAEConfig(**cfg), video=True,
                         time_mode=time_mode)
    _carry_vae({"decoder/" + k: v for k, v in flat.items()}, fresh, pre)
    got = fresh(torch.from_numpy(z).permute(0, 3, 1, 2), t).permute(
        0, 2, 3, 1)
    close(got, want, REL, time_mode)
