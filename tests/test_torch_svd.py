"""Port parity, SVD inference: the tiny engine end to end against the JAX
engine, the weight carrier against the JAX package's own importer, and
the ``svd_test`` CLI.

The tiny engine is ``svd_test --tiny_model`` at 3 frames, 2 steps and
64x48 images (f32). The JAX engine's parameters, every leaf moved by a
seeded N(0, 0.05^2) draw (zero-initialised layers included), are carried
into the port; the conditioning, one denoiser evaluation, the sampler
from the same injected noise and the decoded frames are compared at 1e-4
of the largest magnitude (f32 sums in another order through ~40 layers,
and the Euler steps multiply the denoiser's error by up to sigma_max /
sigma_1's ratio of the update).
"""

import argparse
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from multiview_inpaint_tpu.diffusion import edm as jedm
from multiview_inpaint_tpu.diffusion import engine as jengine
from multiview_inpaint_tpu.diffusion import samplers as jsamplers
from multiview_inpaint_tpu.diffusion import weights_io
from multiview_inpaint_tpu.pipelines import svd_test as jsvd_test
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.diffusion import engine as tengine
from multiview_inpaint_tpu_torch.gs import scene_io
from multiview_inpaint_tpu_torch.pipelines import svd_test
from multiview_inpaint_tpu_torch.utils import synthetic

from test_torch_diffusion import check, nested, perturb

T, STEPS, SIZE = 3, 2, (64, 48)
COMPONENTS = ("unet", "controlnet", "vae", "clip")


def _tiny_args():
    return argparse.Namespace(tiny_model=True, num_frames=T,
                              num_steps=STEPS, compute_dtype="float32")


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, JAX state, port engine, perturbed flat JAX params)."""
    cfg = jsvd_test._engine_config(_tiny_args())
    state = jengine.init_engine(cfg, jax.random.key(0), latent_hw=(8, 6),
                                image_hw=SIZE)
    flat = perturb({c: getattr(state, c) for c in COMPONENTS}, 70)
    state = jengine.EngineState(**{
        c: nested({k[len(c) + 1:]: v for k, v in flat.items()
                   if k.startswith(c + "/")}) for c in COMPONENTS})
    teng = tengine.init_engine(svd_test._engine_config(_tiny_args()),
                               device="cpu")
    report = teng.load_reference_state_dict(
        checkpoint.state_dict_from_jax(flat))
    assert {c: (len(m), len(u)) for c, (m, u) in report.items()} == {
        c: (0, 0) for c in COMPONENTS}
    return jengine.SVDEngine(cfg), state, teng, flat


def _batch(seed=80):
    rng = np.random.default_rng(seed)
    frame = rng.uniform(-1, 1, (1,) + SIZE + (3,)).astype(np.float32)
    return {"cond_frames_without_noise": frame, "cond_frames": frame,
            "fps_id": np.array([6.0], np.float32),
            "motion_bucket_id": np.array([127.0], np.float32),
            "cond_aug": np.array([0.0], np.float32),
            "control_hint": rng.uniform(0, 1, (T,) + SIZE + (7,)).astype(
                np.float32)}


def _conds(jeng, state, teng):
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jc = jeng.prepare_cond(state, jb)
    juc = jeng.prepare_cond(state, jb, unconditional=True)
    juc["control_hint"] = jc["control_hint"]
    tc = teng.prepare_cond(tb)
    tuc = teng.prepare_cond(tb, unconditional=True)
    tuc["control_hint"] = tc["control_hint"]
    return (jc, juc), (tc, tuc)


def test_tiny_engine_conditioning_and_denoiser_match_jax(engines):
    jeng, state, teng, _ = engines
    (jc, juc), (tc, tuc) = _conds(jeng, state, teng)
    for k in jc:
        check(tc[k], jc[k], 1e-5, k)
    x = np.random.default_rng(81).normal(size=(T, 8, 6, 4)).astype(
        np.float32)
    sig = np.full((T,), 3.7, np.float32)
    want = jeng.denoise_fn(state)(jnp.asarray(x), jnp.asarray(sig), jc)
    got = teng.denoise_fn()(torch.from_numpy(x), torch.from_numpy(sig), tc)
    check(got, want, 1e-4, "denoiser")
    # the ControlNet's residuals reach the output
    no_ctrl = dict(tc, control_hint=torch.zeros_like(tc["control_hint"]))
    moved = teng.denoise_fn()(torch.from_numpy(x), torch.from_numpy(sig),
                              no_ctrl)
    assert float((moved - got).abs().max()) > 1e-4


def test_tiny_engine_sample_matches_jax_euler_edm(engines):
    jeng, state, teng, _ = engines
    (jc, juc), (tc, tuc) = _conds(jeng, state, teng)
    noise = np.random.default_rng(82).normal(size=(T, 8, 6, 4)).astype(
        np.float32)
    sigmas = jnp.concatenate([jedm.edm_sigmas(STEPS), jnp.zeros((1,))])
    want = jsamplers.euler_edm_sample(
        jeng.denoise_fn(state), jnp.asarray(noise), jc, juc, sigmas,
        guider=jeng.guider, key=jax.random.key(1))
    got = teng.sample(tc, tuc, noise=torch.from_numpy(noise))
    check(got, want, 1e-4, "latents")
    frames = teng.decode_first_stage(got, T)
    check(frames, jeng.decode_first_stage(state, want, timesteps=T), 1e-4,
          "frames")
    assert frames.shape == (T,) + SIZE + (3,)


def test_weights_round_trip_through_the_jax_importer(engines):
    """The port's reference-keyed state dict, fed to the JAX package's
    ``weights_io`` importers against the JAX init, gives back exactly the
    parameters the carrier was given, with nothing missing or left over:
    the port's module names are the SVD checkpoint's key space."""
    jeng, _, teng, flat = engines
    cfg = jsvd_test._engine_config(_tiny_args())
    init = jengine.init_engine(cfg, jax.random.key(5), latent_hw=(8, 6),
                               image_hw=SIZE)
    sd = {k: v.numpy() for k, v in teng.reference_state_dict().items()}
    assert all(any(k.startswith(p) for p in checkpoint.PREFIXES.values())
               for k in sd)
    merged, report = weights_io.import_svd(
        {"unet": init.unet, "vae": init.vae, "clip": init.clip}, sd,
        clip_heads=cfg.vit.heads)
    assert report == {"unet": (0, 0), "vae": (0, 0), "clip": (0, 0)}
    merged["controlnet"], missing, unexpected = weights_io.import_controlnet(
        init.controlnet, sd)
    assert missing == [] and unexpected == []
    got = flatten_dict(merged, sep="/")
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def test_svd_test_cli_on_a_synthetic_gs_tree(tmp_path):
    root = str(tmp_path / "gs")
    synthetic.write_gs_tree(root, scene="toy_case", ctrl="ctrl_0",
                            modes=("x1", "x2"), frames=T, size=SIZE,
                            iteration=40)
    logdir = str(tmp_path / "logs")
    svd_test.main(["--data_root", root, "--logdir", logdir, "--tiny_model",
                   "--num_frames", str(T), "--num_steps", str(STEPS),
                   "--size", str(SIZE[0]), str(SIZE[1]), "--iteration",
                   "40", "--device", "cpu"])
    grids = os.listdir(os.path.join(logdir, "log_img", "test"))
    assert len(grids) == 2  # one per mode
    for mode in ("x1", "x2"):
        d = os.path.join(root, "inpainted", "toy_case", "ctrl_0", mode)
        assert sorted(os.listdir(d)) == [f"{i:02d}.png" for i in range(T)]
        img = scene_io.load_image(os.path.join(d, "00.png"))
        assert img.shape == (SIZE[0], SIZE[1], 3)
        assert np.isfinite(img).all() and img.std() > 0


def test_svd_test_cli_loads_jax_and_torch_checkpoints(engines, tmp_path,
                                                      capsys):
    """--base_ckpt/--ctrl_ckpt in the JAX npz layout and in the torch key
    space load with nothing missing and nothing left over."""
    _, _, teng, flat = engines
    base = str(tmp_path / "base.npz")
    np.savez(base, **{k: v for k, v in flat.items()
                      if not k.startswith("controlnet/")})
    ctrl = str(tmp_path / "ctrl.pth")
    torch.save({k: v for k, v in teng.reference_state_dict().items()
                if k.startswith(checkpoint.PREFIXES["controlnet"])}, ctrl)
    root = str(tmp_path / "gs")
    synthetic.write_gs_tree(root, frames=T, size=SIZE, iteration=7)
    svd_test.main(["--data_root", root, "--logdir", str(tmp_path / "l"),
                   "--tiny_model", "--num_frames", str(T), "--num_steps",
                   "1", "--size", str(SIZE[0]), str(SIZE[1]), "--iteration",
                   "7", "--modes", "x1", "--device", "cpu",
                   "--base_ckpt", base, "--ctrl_ckpt", ctrl])
    out = capsys.readouterr().out
    for comp in COMPONENTS:
        assert f"{comp}: 0 missing, 0 unexpected" in out, out
