"""Port parity, SDS: ``guidance/sds.py`` and ``models/sds_trainer.py``
against the JAX package on the CPU in f32.

- The resizes of the SDS step at its own ratios (1920x1080 and the test
  scene's 64x48 to the prior's square, the prior's 512 to its 64 latent):
  ``resize_nearest`` equal to ``jax.image.resize(..., "nearest")``;
  ``clip_vit.resize_bilinear`` within 2e-5 of ``jax.image.resize(...,
  "bilinear")`` (JAX's own f32 is 1.15e-5 off its float64 evaluation)
  and its gradient, under a seeded cotangent, within 2e-5 of max|JAX| of
  JAX's vjp (the same weights transposed).
- ``SDSGuidance.train_step`` on the tiny UNet2D and 2D VAE: in
  ``test_torch_unet2d.py``, which holds those networks. ``test_step``
  (DDIM) with JAX's start noise on an analytic prior and an identity VAE:
  within 1e-5 of max|JAX|.
- ``sds_train_step`` against the JAX ``sds_train_step`` on the 120-splat
  scene of ``test_torch_train.py`` at 64x48, the SDS term from an
  analytic point-mass prior through an identity VAE at ``sds_size`` 32
  with a weight that makes it ~30% of the loss: the loss, the background
  and SDS terms within 1e-5 relative, every field's gradient (read from
  Adam's first moment) and the densification statistics at the gradient
  bar, the parameters after the step within Adam's sign-flip allowance
  (1e-6 + 1e-3 lr, or 2 lr where |g| is under the bar).
- The analytic point-mass-prior loop of ``tests/test_sds.py`` (120 steps,
  CFG 100, a bright disk as the prior's mode) on the port: the render
  moves toward the disk as the JAX one does (error halved, disk brighter
  than the ground by 0.15).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_inpaint_tpu.guidance import sds as jsds
from multiview_inpaint_tpu.models import gs_trainer as jtrainer
from multiview_inpaint_tpu.models import sds_trainer as jsds_trainer
from multiview_inpaint_tpu.ops import rasterizer as jr
from multiview_inpaint_tpu_torch.diffusion.clip_vit import resize_bilinear
from multiview_inpaint_tpu_torch.gs import cameras as tcameras
from multiview_inpaint_tpu_torch.gs import gaussians as tgaussians
from multiview_inpaint_tpu_torch.guidance import sds as tsds
from multiview_inpaint_tpu_torch.models import gs_trainer as ttrainer
from multiview_inpaint_tpu_torch.models import sds_trainer as tsds_trainer
from multiview_inpaint_tpu_torch.ops import rasterizer as tr
from test_torch_train import (BG, FIELDS, _grad_bar, _port, _step_inputs,
                              _train_scene)

RATIOS = [((1080, 1920), (512, 512)), ((48, 64), (32, 32)),
          ((512, 512), (64, 64)), ((48, 64), (48, 48))]


@pytest.mark.parametrize("src,dst", RATIOS)
def test_resizes_match_jax_at_the_step_ratios(src, dst):
    rng = np.random.default_rng(sum(src))
    mask = (rng.random(src) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        tsds.resize_nearest(torch.from_numpy(mask), dst).numpy(),
        np.asarray(jax.image.resize(jnp.asarray(mask), dst, "nearest")))
    img = rng.random(src + (3,)).astype(np.float32)
    cot = rng.normal(size=dst + (3,)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax.image.resize(x, dst + (3,),
                                                   "bilinear"),
                        jnp.asarray(img))
    (g_want,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(img).requires_grad_(True)
    got = resize_bilinear(x[None], dst)[0]
    (g_got,) = torch.autograd.grad(got, x, torch.from_numpy(cot))
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= 2e-5
    g_want = np.asarray(g_want)
    assert np.abs(g_got.numpy() - g_want).max() <= 2e-5 * np.abs(
        g_want).max()


def _key_draws(key, shape):
    """The t and noise the JAX ``train_step`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    t = jax.random.randint(k1, (1,), 20, 981)
    return (torch.from_numpy(np.array(t)).long(),
            torch.from_numpy(np.array(jax.random.normal(k2, shape))))


def _identity_vae(lib):
    cat = torch.cat if lib is torch else jnp.concatenate

    def enc(img):
        z = img[..., :1] * 0
        return cat([img, z], -1)

    return enc, lambda z: z[..., :3]


def _point_mass_eps(lib, target, acp_tab):
    """The optimal eps of a prior whose mass sits at ``target`` latents:
    (x_t - sqrt(acp) M) / sqrt(1 - acp), the same for cond and uncond."""
    m_lat = _identity_vae(lib)[0](target[None])
    sqrt, cat = ((torch.sqrt, torch.cat) if lib is torch else
                 (jnp.sqrt, jnp.concatenate))

    def eps_model(x9, t, emb):
        idx = t.long() if lib is torch else t.astype(jnp.int32)
        acp = acp_tab[idx].reshape(-1, 1, 1, 1)
        m = cat([m_lat] * x9.shape[0], 0)
        return (x9[..., :4] - sqrt(acp) * m) / sqrt(1.0 - acp)
    return eps_model


def _guidances(size, scale=100.0):
    yy, xx = np.mgrid[0:size, 0:size]
    disk = (((yy - size / 2) ** 2 + (xx - size / 2) ** 2)
            < (size * 0.3) ** 2).astype(np.float32)
    target = np.stack([disk] * 3, -1) * 0.9 + 0.05
    jenc, jdec = _identity_vae(jnp)
    tenc, tdec = _identity_vae(torch)
    jg = jsds.SDSGuidance(_point_mass_eps(
        jnp, jnp.asarray(target), jsds.DDPMSchedule().alphas_cumprod()),
        jenc, jdec, jsds.SDSConfig(guidance_scale=scale))
    tg = tsds.SDSGuidance(_point_mass_eps(
        torch, torch.from_numpy(target), tsds.DDPMSchedule().alphas_cumprod()),
        tenc, tdec, tsds.SDSConfig(guidance_scale=scale))
    return jg, tg, disk, target


def test_test_step_matches_jax():
    jg, tg, _, _ = _guidances(16)
    img = np.random.default_rng(6).random((16, 16, 3)).astype(np.float32)
    mask = np.ones((16, 16), np.float32)
    text = np.zeros((2, 1, 8), np.float32)
    key = jax.random.key(7)
    want = np.asarray(jg.test_step(key, jnp.asarray(img), jnp.asarray(mask),
                                   jnp.asarray(text), start_t=0.5,
                                   num_steps=8))
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(key)[0], (1, 16, 16, 4))))
    got = tg.test_step(torch.from_numpy(img), torch.from_numpy(mask),
                       torch.from_numpy(text), start_t=0.5, num_steps=8,
                       noise=noise).numpy()
    assert got.shape == (16, 16, 3)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_sds_train_step_matches_jax():
    size, spatial, weight = 32, 1.3, 2e-3
    jg, tg, _, _ = _guidances(size)
    jp = _train_scene()
    cam, gt, mask = _step_inputs()
    text = np.zeros((2, 1, 8), np.float32)
    cfg = jtrainer.OptimizationConfig()
    key = jax.random.key(8)
    jnew, jm = jsds_trainer.sds_train_step(
        jtrainer.init_state(jp), jr.RenderCamera.from_camera(cam),
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(BG, jnp.float32),
        cfg, jg, jnp.asarray(text), key, spatial_lr_scale=spatial,
        sds_weight=weight, sds_size=size, max_per_tile=1024,
        pair_budget_mult=64)
    t, noise = _key_draws(key, (1, size, size, 4))
    tnew, tm = tsds_trainer.sds_train_step(
        ttrainer.init_state(_port(jp)),
        tr.RenderCamera.from_camera(cam, "cpu"), torch.from_numpy(gt),
        torch.from_numpy(mask), torch.tensor(BG),
        ttrainer.OptimizationConfig(), tg, torch.from_numpy(text),
        spatial_lr_scale=spatial, sds_weight=weight, sds_size=size, t=t,
        noise=noise)
    for a, b in ((tm.loss, jm.loss), (tm.bg_loss, jm.bg_loss),
                 (tm.sds_loss, jm.sds_loss)):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b)), (a, b)
    assert 0.2 < weight * float(jm.sds_loss) / float(jm.loss) < 0.5
    assert tm.pairs == int(jm.pairs) > 0 and int(tm.nonfinite_grads) == 0
    lrs = jtrainer._group_lrs(cfg, jnp.int32(1), spatial)
    for f in FIELDS:
        g_want = np.asarray(jnew.mu[f]) / 0.1
        bar = _grad_bar(g_want)
        np.testing.assert_allclose(tnew.mu[f].numpy() / 0.1, g_want,
                                   atol=bar, err_msg=f)
        lr = float(lrs[f])
        diff = np.abs(getattr(tnew.params, f).numpy()
                      - np.asarray(getattr(jnew.params, f)))
        small = np.abs(g_want) <= bar
        assert (diff[small] <= 2 * lr + 1e-6).all(), f
        assert (diff[~small] <= 1e-6 + 1e-3 * lr).all(), f
    ga = np.asarray(jnew.stats.grad_accum)
    np.testing.assert_allclose(tnew.stats.grad_accum.numpy(), ga,
                               atol=_grad_bar(ga))
    np.testing.assert_array_equal(tnew.stats.denom.numpy(),
                                  np.asarray(jnew.stats.denom))


@pytest.fixture
def one_thread():
    """One intra-op thread: the loop below runs thousands of small ops,
    which several threads per op slow by ~100x on a loaded machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_point_mass_prior_loop_grows_the_disk(one_thread):
    """tests/test_sds.py's loop on the port: 400 splats in a thin slab,
    the whole 48x48 view to inpaint, 120 steps."""
    size, n = 48, 400
    _, tg, disk, target = _guidances(size)
    rng = np.random.default_rng(0)
    xyz = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                    rng.uniform(-0.05, 0.05, n)], -1).astype(np.float32)
    params = tgaussians.from_arrays(
        xyz, np.zeros((n, 1, 3), np.float32), np.zeros((n, 0, 3), np.float32),
        np.zeros((n, 1), np.float32),            # logit of opacity 0.5
        np.log(np.full((n, 3), 0.12, np.float32)),
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)), device="cpu")
    cam = tr.RenderCamera.from_camera(tcameras.make_camera(
        0, np.eye(3), np.array([0.0, 0.0, 3.0]), fovx=0.9, fovy=0.9,
        width=size, height=size), "cpu")
    bg = torch.zeros(3)
    mask = torch.ones((size, size))
    gt = torch.zeros((size, size, 3))
    text = torch.zeros((2, 1, 8))

    def render_now(st):
        with torch.no_grad():
            out = tr.render(st.params, cam, bg, device="cpu")
        return np.clip(out.rgb.numpy(), 0, 1)

    state = ttrainer.init_state(params)
    err0 = float(np.mean((render_now(state) - target) ** 2))
    gen = torch.Generator().manual_seed(7)
    for _ in range(120):
        state, _ = tsds_trainer.sds_train_step(
            state, cam, gt, mask, bg, ttrainer.OptimizationConfig(), tg,
            text, sds_weight=1e-4, sds_size=size, generator=gen)
    img1 = render_now(state)
    err1 = float(np.mean((img1 - target) ** 2))
    assert np.isfinite(err1) and err1 < 0.5 * err0, (err0, err1)
    assert img1[disk > 0.5].mean() > img1[disk < 0.5].mean() + 0.15
