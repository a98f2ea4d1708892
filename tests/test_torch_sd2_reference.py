"""The SDS cell's plain reference (``port_bench/reference/sd2``) against
the program on the CPU, at tiny widths on seeded random weights (every
leaf random, the published zero-initialised layers too):

- the program's UNet2D and KL encoder against the reference's, in f32;
- the SDS loss and its gradient with respect to the image, the program's
  guidance (``sds_train.make_guidance``) against the reference prior's;
- the first steps of ``sds_trainer.sds_train_step`` on a tiny insertion
  scene against the reference's steps, through the benchmark driver's
  own check (``drivers/sds_step``): the losses, the box rows' first
  gradient, the change of every row;
- the planted faults of the cell's check (the CFG batch's conditional
  half left out; the encoder's backward cut; the Adam update never
  applied) failing those comparisons, the sound program passing them.

Both sides compute in float32 with the same blocks' arithmetic, so the
bars are a few float32 roundings; the faults move the numbers by O(1).
"""

import dataclasses
import json
import os

import pytest
import torch

from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.diffusion.unet2d import UNet2D, UNet2DConfig
from multiview_inpaint_tpu_torch.diffusion.vae import AutoencoderKL, VAEConfig
from multiview_inpaint_tpu_torch.models.gs_trainer import INPAINT_OPT
from multiview_inpaint_tpu_torch.pipelines.sds_train import (LATENT_SCALE,
                                                             make_guidance)
from port_bench.inputs.weights import seeded
from port_bench.reference.sd2 import prior as ref_prior
from port_bench.reference.sd2.unet import UNetConfig
from port_bench.reference.svd.vae import VAEConfig as RefVAEConfig

TINY_UNET = dict(model_channels=32, num_res_blocks=1,
                 attention_resolutions=(1,), channel_mult=(1, 2),
                 num_head_channels=16, context_dim=16)
TINY_VAE = dict(ch=16, ch_mult=(1, 2, 4, 4), num_res_blocks=1)
SIZE, L = 32, 5
FAULTS = ["cond_left_out", "encoder_cut"]      # the guidance's
STEP_FAULTS = FAULTS + ["state_unchanged"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """(program UNet2D, program VAE, reference prior), one set of seeded
    weights in the checkpoint's key space loaded into both."""
    ucfg, vcfg = UNetConfig(**TINY_UNET), RefVAEConfig(**TINY_VAE)
    sd = seeded(ref_prior.weight_spec(ucfg, vcfg), 11, "cpu",
                lambda k: torch.float32)
    unet = UNet2D(UNet2DConfig(**TINY_UNET))
    vae = AutoencoderKL(VAEConfig(**TINY_VAE), video_decoder=False)
    for module, name in ((unet, "unet"), (vae, "vae")):
        missing, unexpected = checkpoint.import_state_dict(
            module, sd, checkpoint.PREFIXES[name])
        assert not missing and not unexpected, name
    ref = ref_prior.Prior(ucfg, vcfg, 100.0)
    ref.load(sd)
    ref.requires_grad_(False)
    return unet, vae, ref


def _draws(seed):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((SIZE, SIZE, 3), generator=g)
    mask = torch.zeros((SIZE, SIZE))
    mask[8:24, 10:26] = 1.0
    embs = torch.randn((2, L, 16), generator=g)
    t = torch.randint(20, 981, (1,), generator=g)
    noise = torch.randn((1, SIZE // 8, SIZE // 8, 4), generator=g)
    return img, mask, embs, t, noise


def _rel(a, b):
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


@pytest.mark.parametrize("part", ["unet", "encoder"])
def test_networks_match_the_reference(nets, part):
    unet, vae, ref = nets
    img, mask, embs, t, noise = _draws(1)
    with torch.no_grad():
        if part == "unet":
            g = torch.Generator().manual_seed(2)
            x9 = torch.randn((2, SIZE // 8, SIZE // 8, 9), generator=g)
            got = unet(x9, torch.cat([t, t]).float(), embs)
            want = ref.unet(x9, torch.cat([t, t]).float(), embs)
        else:
            got = vae.encode(img[None] * 2 - 1).mode() * LATENT_SCALE
            want = ref.encode(img[None])
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("fault", [None] + FAULTS)
def test_sds_loss_and_image_gradient_match_the_reference(nets, fault):
    from port_bench.drivers.sds_step import faults, image_grad
    unet, vae, ref = nets
    guidance = make_guidance(unet, vae, 100.0)
    if fault:
        faults(guidance, fault)
    img, mask, embs, t, noise = _draws(3)
    got = image_grad(guidance, img, mask, embs, t, noise)
    want = ref.image_grad(img, mask, embs, t, noise)
    loss = float(guidance.train_step(img, mask, embs, t=t, noise=noise))
    loss_ref = float(ref.sds_loss(img, mask, embs, t, noise))
    if fault is None:
        assert _rel(got, want) < 1e-5
        assert abs(loss - loss_ref) <= 1e-5 * abs(loss_ref)
    else:
        assert _rel(got, want) > 0.5
        if fault == "cond_left_out":
            assert abs(loss - loss_ref) > 0.5 * abs(loss_ref)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """A run of the SDS cell at tiny sizes on the CPU, its inputs and its
    weight list."""
    from port_bench.drivers import sds_step
    from port_bench.harness.context import Run
    from port_bench.harness.loader import Manifest
    from port_bench.tests.sds_tiny import shrink
    from port_bench.tests.tiny import tiny_bench
    manifest, bench = tiny_bench(str(tmp_path_factory.mktemp("bench")))
    shrink(bench)
    m = Manifest(manifest, bench)
    spec = m.cell("sds-1080p")
    run = Run(torch, torch.device("cpu"), seed=3000000777, seconds=0,
              trace=False, config=m.config(spec), traffic=m.traffic(spec),
              cell=spec, t_start=0.0)
    weights = sds_step.weight_list(run.config)
    inp = sds_step.setup(run)
    sound = sds_step.program_first_steps(
        run, inp, sds_step.load_guidance(run, weights),
        sds_step.program_params(run, inp))[1]
    want = sds_step.reference_readings(run, inp, weights, sound["image"],
                                       sound["mask"])
    return run, inp, weights, sound, want


@pytest.mark.parametrize("fault", [None] + STEP_FAULTS)
def test_sds_steps_match_the_reference(cell, fault):
    from port_bench.drivers import sds_step
    run, inp, weights, prog, want = cell
    assert all(0 < m.mean() < 1 for m in inp.masks)
    if fault:
        guidance = sds_step.load_guidance(run, weights)
        with sds_step.planted(guidance, fault):
            prog = sds_step.program_first_steps(
                run, inp, guidance, sds_step.program_params(run, inp))[1]
    gaps = sds_step.gaps(prog, want)
    limits = run.traffic["limits"]
    assert set(limits) <= set(gaps)
    if fault is None:
        # float32 on both sides: the render's and the prior's sums in
        # other orders, and Adam's first steps (lr x sign) on gradients
        # near round-off
        assert gaps["sds_grad_rms"] < 1e-5
        assert gaps["loss_gap"] < 1e-4
        assert gaps["box_grad_gap"] < 1e-5
        assert gaps["change_gap"] < 5e-4
    else:
        assert max(gaps[k] / limits[k] for k in limits) >= 10, gaps


def test_configuration_is_the_clis_prior():
    """The cell's configuration file holds the CLI's prior and preset:
    the port's default UNet2D and VAE (SD-2-inpainting's published
    widths) and ``INPAINT_OPT``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "port_bench", "configs",
                           "sd2-inpaint-sds.json")) as f:
        cfg = json.load(f)
    assert UNet2DConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in cfg["unet"].items()}) == UNet2DConfig()
    vae = VAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in cfg["vae"].items()})
    assert vae == VAEConfig()
    assert cfg["optimization"] == dataclasses.asdict(INPAINT_OPT)
    assert cfg["latent_scale"] == LATENT_SCALE
    assert cfg["reduced"] == []
