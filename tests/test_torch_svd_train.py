"""Port parity, SVD ControlNet training: losses, warp maps, datasets,
the weight carrier back to JAX, checkpoints, the tiny engine's gradients
and one train step against JAX + optax, the optimizer's schedules and
accumulation against optax, remat, and the ``svd_train`` CLI.

The tiny engine is ``svd_train --tiny_model`` at 3 frames and 64x48
images, f32. Its JAX twin is built from the port's weights through
``checkpoint.state_dict_to_jax`` (whose tree is first held against the
JAX init's, key by key and shape by shape), every parameter moved by a
seeded draw so that zero-initialised layers show. JAX's random draws
(sigma per video, noise) are reproduced from its key split and injected
into the port.

Bars: losses 1e-6 relative (the same f32 math); warp maps and datasets
exact; gradients 1e-4 of each tensor's max|g| (f32 sums in another order
through ~40 layers, the bar of the denoiser's parity test) plus 1e-5 of the
largest |g| of all (a bias added right before a GroupNorm has a gradient
that is zero but for rounding, ~1e-9 here); Adam's first
step is g / (|g| + eps), sign-like, so parameters after it are compared
where |g| >= 1e-6 (well above eps = 1e-8) within 1e-3 lr, and the rest
are counted; the optimizer alone against optax 1e-6 relative in f32 and
one bf16 spacing in bf16 (pow and cos of XLA and numpy may differ in the
last place of the f32 bias correction or schedule).
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from multiview_inpaint_tpu.data import svd_dataset as jdata
from multiview_inpaint_tpu.data import warp as jwarp
from multiview_inpaint_tpu.diffusion import checkpoint as jckpt
from multiview_inpaint_tpu.diffusion import edm as jedm
from multiview_inpaint_tpu.diffusion import engine as jengine
from multiview_inpaint_tpu.diffusion import losses as jlosses
from multiview_inpaint_tpu.parallel import svd_data_parallel as jdp
from multiview_inpaint_tpu.pipelines import svd_train as jsvd_train
from multiview_inpaint_tpu_torch.data import svd_dataset as tdata
from multiview_inpaint_tpu_torch.data import warp as twarp
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.diffusion import edm as tedm
from multiview_inpaint_tpu_torch.diffusion import engine as tengine
from multiview_inpaint_tpu_torch.diffusion import losses as tlosses
from multiview_inpaint_tpu_torch.parallel import svd_data_parallel as tdp
from multiview_inpaint_tpu_torch.pipelines import svd_train
from multiview_inpaint_tpu_torch.utils import synthetic

T, SIZE, LAT = 3, (64, 48), (8, 6)
COMPONENTS = ("unet", "controlnet", "vae", "clip")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's many small ops on one intra-op thread: on PyTorch's
    default threads they thrash when several test workers share the
    cores (the CLI tests took 3-25x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(**kw):
    return argparse.Namespace(**dict(dict(
        tiny_model=True, num_frames=T, pose_cond=False, warp_loss=False),
        **kw))


def _jax_draws(key, b):
    """The sigma per video and the noise JAX's train step draws from
    ``key`` for b videos (split per video, then k1 / k2 per video)."""
    sig, noise = [], []
    for k in jax.random.split(key, b):
        k1, k2 = jax.random.split(k)
        sig.append(np.asarray(jedm.edm_sigma_sample(k1, (1,))))
        noise.append(np.asarray(jax.random.normal(k2, (T,) + LAT + (4,))))
    return np.concatenate(sig), np.stack(noise)


# --- losses ----------------------------------------------------------------

def _denoiser(mod):
    def fn(x, s, c):
        s = s.reshape((-1,) + (1,) * (x.ndim - 1))
        return x * c["a"] / (1 + s) + c["b"]
    return fn


@pytest.mark.parametrize("kind,loss_type,weighting", [
    ("standard", "l2", "edm"), ("standard", "l1", "eps"),
    ("inpaint", "l2", "edm"), ("inpaint", "l1", "v"),
    ("inpaint", "l2", "unit"), ("warp", "l2", "edm"), ("warp", "l1", "edm"),
])
def test_losses_match_jax(kind, loss_type, weighting):
    rng = np.random.default_rng(1)
    b = 1 if kind == "warp" else 2
    lat = rng.normal(size=(b * T,) + LAT + (4,)).astype(np.float32)
    c = {"a": rng.normal(size=(b * T,) + LAT + (4,)).astype(np.float32),
         "b": rng.normal(size=(1,)).astype(np.float32)}
    key = jax.random.key(7)
    k1, k2 = jax.random.split(key)
    kw = dict(loss_type=loss_type, weighting=weighting)
    warp = None
    if kind == "warp":
        hw = LAT[0] * LAT[1]
        warp = {"hit_map": (rng.random((T - 1,) + LAT) > 0.3).astype(
            np.float32),
            "uv_ind": rng.integers(0, hw, (T - 1, 4, hw)).astype(np.int32)}
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    tc = {k: torch.from_numpy(v) for k, v in c.items()}
    if kind == "standard":
        want = jlosses.standard_diffusion_loss(_denoiser(jnp), key,
                                               jnp.asarray(lat), jc, **kw)
        sig = jedm.edm_sigma_sample(k1, (b * T,))
    else:
        want = jlosses.inpaint_diffusion_loss(
            _denoiser(jnp), key, jnp.asarray(lat), jc, num_video_frames=T,
            warp=None if warp is None else {
                k: jnp.asarray(v) for k, v in warp.items()}, **kw)
        sig = jedm.edm_sigma_sample(k1, (b,))
    noise = jax.random.normal(k2, lat.shape)
    draws = dict(sigmas=torch.from_numpy(np.array(sig)),
                 noise=torch.from_numpy(np.array(noise)))
    if kind == "standard":
        got = tlosses.standard_diffusion_loss(
            _denoiser(torch), torch.from_numpy(lat), tc, **kw, **draws)
    else:
        got = tlosses.inpaint_diffusion_loss(
            _denoiser(torch), torch.from_numpy(lat), tc, T, **kw, **draws,
            warp=None if warp is None else {
                k: torch.from_numpy(v) for k, v in warp.items()})
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_sigma_sampling_and_weightings_match_jax():
    n = np.random.default_rng(2).normal(size=(6,)).astype(np.float32)
    s = tedm.edm_sigma_sample((6,), normal=torch.from_numpy(n))
    np.testing.assert_allclose(s.numpy(), np.exp(1.0 + 1.6 * n), rtol=1e-6)
    sj = jnp.asarray(s.numpy())
    for name in ("edm", "v", "eps", "unit"):
        np.testing.assert_allclose(
            tlosses.WEIGHTINGS[name](s).numpy(),
            np.asarray(jlosses.WEIGHTINGS[name](sj)), rtol=1e-6)


# --- warp maps and datasets ------------------------------------------------

def test_compute_warp_maps_exact():
    rng = np.random.default_rng(3)
    depths = rng.uniform(0.5, 3.0, (4, 32, 24)).astype(np.float32)
    depths[1, :4] = 0.0                        # invalid depth
    poses = np.tile(np.eye(4), (4, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 0.3, 4)
    poses[:, 2, 3] = np.linspace(0, -0.2, 4)
    K = np.array([[30.0, 0, 12], [0, 30.0, 16], [0, 0, 1]])
    got = twarp.compute_warp_maps(depths, poses, K, (8, 6))
    want = jwarp.compute_warp_maps(depths, poses, K, (8, 6))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert 0 < got[0].mean() < 1


def _same_items(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kw", [
    dict(mask_shrink_k=0.3, pose_cond=True, cond_aug=0.02, seed=3),
    dict(pose_cond=True, pose_fn="v2", reversal=False, sample_id=1,
         repeat=3, hint_frames_dir="rgb"),
])
def test_est_dataset_matches_jax_bit_for_bit(tmp_path, kw):
    root = str(tmp_path / "est")
    synthetic.write_est_tree(root, scenes=2, frames=T, size=SIZE)
    dsj = jdata.EstSVDForwardDataset(root, size=SIZE, num_frames=T, **kw)
    dst = tdata.EstSVDForwardDataset(root, size=SIZE, num_frames=T, **kw)
    assert len(dsj) == len(dst)
    for epoch in range(2):
        for (ij, bj), (it, bt) in zip(jdata.epoch_iterator(dsj, seed=epoch),
                                      tdata.epoch_iterator(dst, seed=epoch)):
            assert ij == it
            _same_items(bt, bj)


def test_warp_dataset_matches_jax_bit_for_bit(tmp_path):
    root = str(tmp_path / "warp")
    synthetic.write_est_tree(root, scenes=2, frames=T, size=SIZE, warp=True)
    dsj = jdata.WarpSVDForwardDataset(root, size=SIZE, num_frames=T, seed=4)
    dst = tdata.WarpSVDForwardDataset(root, size=SIZE, num_frames=T, seed=4)
    for epoch in range(2):
        for (ij, bj), (it, bt) in zip(jdata.epoch_iterator(dsj, seed=epoch),
                                      tdata.epoch_iterator(dst, seed=epoch)):
            assert ij == it
            _same_items(bt, bj)
            assert bt["hit_map"].shape == (T - 1,) + LAT
            assert bt["uv_ind"].shape == (T - 1, 4, LAT[0] * LAT[1])


# --- the tiny engine in both packages --------------------------------------

def _moved(teng, seed=60, scale=0.05):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in teng.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen))


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, JAX state from the port's weights, port engine, flat
    JAX params, the JAX init's shapes)."""
    cfg = jsvd_train._engine_config(_args())
    shapes = jax.eval_shape(lambda k: jengine.init_engine(
        cfg, k, latent_hw=LAT, image_hw=SIZE), jax.random.key(0))
    teng = tengine.init_engine(svd_train._engine_config(_args()),
                               device="cpu")
    _moved(teng)
    flat = checkpoint.state_dict_to_jax(teng.reference_state_dict(),
                                        clip_heads=cfg.vit.heads)
    state = jengine.EngineState(**{c: jax.tree_util.tree_map(
        jnp.asarray, _nested({k[len(c) + 1:]: v for k, v in flat.items()
                              if k.startswith(c + "/")}))
        for c in COMPONENTS})
    return jengine.SVDEngine(cfg), state, teng, flat, shapes


def _nested(flat):
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def test_state_dict_to_jax_is_the_jax_param_tree(engines):
    """Every JAX parameter of the tiny engine, by key and shape, and back
    again to the same torch state dict."""
    _, _, teng, flat, shapes = engines
    want = {f"{c}/{k}": v.shape for c in COMPONENTS
            for k, v in flatten_dict(getattr(shapes, c), sep="/").items()}
    assert set(flat) == set(want)
    for k, shape in want.items():
        assert tuple(flat[k].shape) == tuple(shape), k
    back = checkpoint.state_dict_from_jax(flat)
    sd = teng.reference_state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def _cond(b, seed=61):
    rng = np.random.default_rng(seed)
    return {"crossattn": rng.normal(size=(b, T, 1, 16)),
            "vector": rng.normal(size=(b, T, 768)),
            "concat": rng.normal(size=(b, T) + LAT + (4,)),
            "control_hint": rng.uniform(size=(b, T) + SIZE + (7,))}


def _f32(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def _grads_to_jax(grads, heads):
    """Port gradients (reference keys) in the JAX trainable layout."""
    out = {"controlnet/" + k: v for k, v in checkpoint.state_dict_to_jax(
        grads, "controlnet", heads).items()}
    out.update({"label_emb/" + k: v for k, v in checkpoint.state_dict_to_jax(
        grads, "unet", heads).items()})
    return out


def test_controlnet_gradients_match_jax_grad(engines):
    """Loss and gradients of the ControlNet and the label embedding
    (``--train_label_emb``) for one video, JAX's draws injected."""
    jeng, state, teng, _, _ = engines
    lat = np.random.default_rng(62).normal(size=(T,) + LAT + (4,)).astype(
        np.float32)
    cond = _f32({k: v[0] for k, v in _cond(1).items()})
    key = jax.random.key(63)
    trainable = jdp.trainable_params(state, True)

    @jax.jit
    def loss_grad(tr):
        return jax.value_and_grad(lambda p: jeng.loss(
            jdp.apply_trainable(state, p), key, jnp.asarray(lat),
            {k: jnp.asarray(v) for k, v in cond.items()}))(tr)

    want_loss, want = loss_grad(trainable)
    k1, k2 = jax.random.split(key)
    sig = np.asarray(jedm.edm_sigma_sample(k1, (1,)))
    noise = np.asarray(jax.random.normal(k2, lat.shape))
    params = tdp.trainable_params(teng, train_label_emb=True)
    try:
        loss = teng.loss(torch.from_numpy(lat),
                         {k: torch.from_numpy(v) for k, v in cond.items()},
                         sigmas=torch.from_numpy(sig),
                         noise=torch.from_numpy(noise))
        g = torch.autograd.grad(loss, list(params.values()))
    finally:
        teng.requires_grad_(False)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = _grads_to_jax(dict(zip(params, g)), jeng.cfg.vit.heads)
    want = flatten_dict(want, sep="/")
    assert set(got) == set(want)
    gmax = max(np.abs(np.asarray(w)).max() for w in want.values())
    assert gmax > 1e-3
    for k, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[k] - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-5 * gmax, (k, err)


def test_train_step_matches_jax_optax(engines):
    """One step of 2 videos: the JAX data-parallel step (optax Adam, EMA
    0.9) against the port's, JAX's draws injected: loss, the Adam moment
    (0.1 g), parameters and EMA after the step."""
    jeng, state, teng, _, _ = engines
    lr, decay, b = 1e-3, 0.9, 2
    lat = np.random.default_rng(64).normal(size=(b, T) + LAT + (4,)).astype(
        np.float32)
    cond = _f32(_cond(b, 65))
    key = jax.random.key(66)
    opt = jdp.build_optimizer(lr)
    tr = jdp.trainable_params(state)
    copy = lambda t: jax.tree_util.tree_map(jnp.copy, t)  # noqa: E731
    step = jdp.make_dp_train_step(jeng, opt, ema_decay=decay)
    new_state, opt_state, ema, loss = step(
        copy(state), opt.init(tr), copy(tr), key, jnp.asarray(lat),
        {k: jnp.asarray(v) for k, v in cond.items()})
    sig, noise = _jax_draws(key, b)

    before = {k: v.detach().clone() for k, v in teng.controlnet.state_dict(
    ).items()}
    params = tdp.trainable_params(teng)
    try:
        topt = tdp.build_optimizer(lr)
        tstate = topt.init(params)
        tema = {k: p.detach().clone() for k, p in params.items()}
        tloss = tdp.make_train_step(teng, topt, params, decay)(
            tstate, tema, torch.from_numpy(lat),
            {k: torch.from_numpy(v) for k, v in cond.items()},
            sigmas=torch.from_numpy(sig), noise=torch.from_numpy(noise))
        got_p = checkpoint.state_dict_to_jax(
            {k: p.detach() for k, p in params.items()}, "controlnet")
        got_mu = checkpoint.state_dict_to_jax(tstate["mu"], "controlnet")
        got_ema = checkpoint.state_dict_to_jax(tema, "controlnet")
    finally:
        teng.controlnet.load_state_dict(before)
        teng.requires_grad_(False)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    assert tstate["count"] == 1
    mu = flatten_dict(opt_state[0].mu["controlnet"], sep="/")
    want_p = flatten_dict(new_state.controlnet, sep="/")
    want_ema = flatten_dict(ema["controlnet"], sep="/")
    small = total = 0
    mmax = max(np.abs(np.asarray(m)).max() for m in mu.values())
    for k, m in mu.items():
        m = np.asarray(m)
        assert np.abs(got_mu[k] - m).max() <= (1e-4 * np.abs(m).max()
                                               + 1e-5 * mmax), k
        big = np.abs(m) >= 1e-7             # |g| >= 1e-6
        for got, want in ((got_p, want_p), (got_ema, want_ema)):
            w = np.asarray(want[k])
            assert np.abs(got[k] - w)[big].max(initial=0) <= 1e-3 * lr, k
        small += int((~big).sum())
        total += m.size
    moved = sum(int((np.asarray(want_p[k]) != np.asarray(
        flatten_dict(state.controlnet, sep="/")[k])).sum()) for k in mu)
    assert moved > total // 2 and small < total // 4


# --- the optimizer alone ---------------------------------------------------

@pytest.mark.parametrize("schedule,accumulate,dtype", [
    ("constant", 1, "float32"), ("linear", 1, "float32"),
    ("warmup_cosine", 1, "float32"), ("constant", 3, "float32"),
    ("warmup_cosine", 2, "float32"), ("constant", 1, "bfloat16"),
    ("linear", 2, "bfloat16"),
])
def test_adam_schedules_and_multisteps_match_optax(schedule, accumulate,
                                                   dtype):
    rng = np.random.default_rng(70)
    shapes = {"a": (5, 7), "b": (11,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jopt = jdp.build_optimizer(0.05, schedule, warmup_steps=2,
                               total_steps=6, accumulate=accumulate)
    topt = tdp.build_optimizer(0.05, schedule, warmup_steps=2,
                               total_steps=6, accumulate=accumulate)
    jp = {k: jnp.asarray(v, dtype) for k, v in p0.items()}
    tp = {k: torch.tensor(v, dtype=getattr(torch, dtype))
          for k, v in p0.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for i in range(8):
        g = {k: rng.normal(size=s).astype(np.float32) * 10.0 ** (i % 3 - 1)
             for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v, dtype)
                                   for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, {k: torch.from_numpy(v).to(getattr(torch, dtype))
                       for k, v in g.items()}, tstate)
        for k in shapes:
            want = np.asarray(jp[k].astype(jnp.float32))
            got = tp[k].float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{k} step {i}")
            else:   # one bf16 spacing
                spacing = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30))
                                  - 7)
                assert (np.abs(got - want) <= spacing).all(), (k, i)
    moved = np.abs(tp["a"].float().numpy() - p0["a"]).max()
    assert moved > 0.01


def test_learning_rate_schedules_match_optax():
    for schedule, want in (
            ("linear", optax.linear_schedule(3e-4, 0.0, 20, 5)),
            ("warmup_cosine", optax.warmup_cosine_decay_schedule(
                0.0, 3e-4, 5, 20))):
        opt = tdp.build_optimizer(3e-4, schedule, 5, 20)
        for c in range(0, 30):
            np.testing.assert_allclose(opt.learning_rate(c),
                                       float(want(c)), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{schedule} {c}")
    assert tdp.build_optimizer(3e-4).learning_rate(7) == np.float32(3e-4)


# --- remat -----------------------------------------------------------------

@pytest.mark.parametrize("remat", ["all", "attn"])
def test_remat_gradients_equal_no_remat(engines, remat):
    _, _, teng, _, _ = engines
    rng = np.random.default_rng(71)
    lat = torch.from_numpy(rng.normal(size=(T,) + LAT + (4,)).astype(
        np.float32))
    cond = {k: torch.from_numpy(v[0]).float() for k, v in _cond(1).items()}
    draws = dict(sigmas=torch.tensor([1.3]),
                 noise=torch.from_numpy(rng.normal(size=lat.shape).astype(
                     np.float32)))
    cfg = dataclasses.replace(teng.cfg, remat=remat)
    reng = tengine.SVDEngine(cfg, device="cpu")
    reng.load_reference_state_dict(teng.reference_state_dict())
    grads = []
    for eng in (teng, reng):
        params = tdp.trainable_params(eng)
        try:
            loss = eng.loss(lat, cond, **draws)
            grads.append(torch.autograd.grad(loss, list(params.values())))
        finally:
            eng.requires_grad_(False)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


# --- checkpoints ------------------------------------------------------------

def test_checkpoint_round_trip_both_ways(engines, tmp_path):
    """Port -> JAX: ``save_params`` (bf16 tensors as f32) read by the JAX
    ``load_params``. JAX -> port: a JAX ``save_params`` file holding a
    bf16 leaf (numpy's raw ``'<V2'``) read by the port as its exact
    values. ``merge_params`` as the JAX one, and the ControlNet checkpoint
    layout as the JAX tree."""
    _, state, teng, flat, shapes = engines
    cn = checkpoint.state_dict_to_jax(
        {k: v.to(torch.bfloat16) for k, v in teng.reference_state_dict(
        ).items()}, "controlnet")
    path = str(tmp_path / "port.npz")
    checkpoint.save_params(path, cn)
    loaded = flatten_dict(jckpt.load_params(path), sep="/")
    want = flatten_dict(shapes.controlnet, sep="/")
    assert set(loaded) == set(want)
    for k, v in loaded.items():
        assert v.dtype == jnp.float32 and v.shape == want[k].shape
        assert np.array_equal(np.asarray(v), cn[k])

    jpath = str(tmp_path / "jax.npz")
    bf = jnp.asarray(np.random.default_rng(72).normal(size=(3, 4)),
                     jnp.bfloat16)
    jckpt.save_params(jpath, {"a": {"w": bf}, "b": jnp.ones((2,))})
    with np.load(jpath) as z:
        assert z["a/w"].dtype.kind == "V"      # the raw bf16 record
    got = checkpoint.load_params(jpath)
    assert np.array_equal(got["a/w"], np.asarray(bf.astype(jnp.float32)))
    assert np.array_equal(got["b"], np.ones((2,), np.float32))

    base = {"a/w": np.zeros((3, 4)), "a/b": np.zeros(2), "c": np.zeros(1)}
    new = {"a/w": np.ones((3, 4)), "a/b": np.ones(3), "d": np.ones(1)}
    merged, missing, unexpected = checkpoint.merge_params(base, new)
    jm, jmissing, junexpected = jckpt.merge_params(_nested(base),
                                                   _nested(new))
    assert sorted(missing) == sorted(jmissing) == ["c"]
    assert sorted(unexpected) == sorted(junexpected) == ["a/b", "d"]
    jm = flatten_dict(jm, sep="/")
    assert set(merged) == set(jm)
    for k in merged:
        assert np.array_equal(merged[k], jm[k])


# --- the CLI ----------------------------------------------------------------

def _cli(data, logdir, *extra):
    svd_train.main(["--data_root", data, "--logdir", logdir, "--tiny_model",
                    "--epochs", "1", "--devices", "1", "--num_frames",
                    str(T), "--size", str(SIZE[0]), str(SIZE[1]),
                    "--ckpt_every", "1", "--log_interval", "1", "--device",
                    "cpu", *extra])


def _log(logdir):
    with open(os.path.join(logdir, "svd_train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_svd_train_cli(engines, tmp_path, capsys):
    """mask shrink + pose conditioning; the checkpoint is the JAX
    ControlNet tree and resumes with nothing missing."""
    _, _, _, _, shapes = engines
    data = str(tmp_path / "est")
    synthetic.write_est_tree(data, scenes=1, frames=T, size=SIZE)
    logdir = str(tmp_path / "logs")
    _cli(data, logdir, "--mask_shrink_k", "0.3", "--pose_cond")
    ckpts = os.listdir(os.path.join(logdir, "checkpoints"))
    assert ckpts == ["epoch=000000.npz"]
    assert any(np.isfinite(r.get("loss", np.nan)) for r in _log(logdir))
    path = os.path.join(logdir, "checkpoints", ckpts[0])
    tree = flatten_dict(jckpt.load_params(path), sep="/")
    # adm 256 * 6 with the pose keys: the trunk's label embedding is wider
    assert tree["trunk/label_emb_0_0/kernel"].shape == (256 * 6, 128)
    assert set(tree) == set(flatten_dict(shapes.controlnet, sep="/"))
    capsys.readouterr()
    _cli(data, str(tmp_path / "again"), "--pose_cond", "--resume", path,
         "--epochs", "0")
    assert "resume: 0 missing, 0 unexpected" in capsys.readouterr().out


def test_svd_train_ckpt_rotation_and_final_ema_eval(tmp_path):
    data = str(tmp_path / "est")
    synthetic.write_est_tree(data, scenes=1, frames=T, size=SIZE)
    logdir = str(tmp_path / "logs")
    _cli(data, logdir, "--epochs", "4", "--ema", "--keep_last", "2",
         "--final_ema_eval", "1", "--lr", "0.05")
    ckpts = sorted(os.listdir(os.path.join(logdir, "checkpoints")))
    assert ckpts == ["epoch=000002.npz", "epoch=000003.npz"]
    fin = [r for r in _log(logdir) if r.get("event") == "final_ema_eval"]
    assert len(fin) == 1
    assert np.isfinite(fin[0]["loss_raw"]) and np.isfinite(fin[0]["loss_ema"])
    # 4 steps at decay 0.9999: the EMA stays near the init, the raw
    # weights have moved
    assert fin[0]["loss_raw"] != fin[0]["loss_ema"]


def test_svd_train_warp_cli(tmp_path):
    data = str(tmp_path / "warp")
    synthetic.write_est_tree(data, scenes=1, frames=T, size=SIZE, warp=True)
    logdir = str(tmp_path / "logs")
    _cli(data, logdir, "--warp_loss", "--train_label_emb")
    ckpts = os.listdir(os.path.join(logdir, "checkpoints"))
    assert ckpts == ["epoch=000000.npz"]
    tree = jckpt.load_params(os.path.join(logdir, "checkpoints", ckpts[0]))
    assert sorted(tree) == ["controlnet", "label_emb"]
    assert sorted(tree["label_emb"]) == ["label_emb_0_0", "label_emb_0_2"]
    assert np.isfinite(_log(logdir)[0]["loss"])
