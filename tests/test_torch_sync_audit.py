"""Every host wait on the device along the four hot program paths sits
in a ``host_read`` span, so that span's host time is all of the host's
waiting there.

One unit of each path runs at full size under
``torch.cuda.set_sync_debug_mode("error")``, which raises at any
operation that makes the host wait for the device (a read of a device
value, a blocking copy to the card, a synchronisation), with the mode
lifted only inside ``telemetry.host_read`` spans:

- a frame of ``api.render`` (no gradients) and a
  ``gs_trainer.train_step``, on 2,000,000 splats at SH degree 3 (the
  layout of ``utils.synthetic.make_big_scene``, a densified Mip-NeRF 360
  capture's scale) in a 1920x1080 view at fovx 1.1, fovy 0.7;
- a clip of the SVD-XT engine with its ControlNet at full width, weights
  in bfloat16 and computing in bfloat16: 14 frames at 512x384, the
  conditioning of c and uc, two Euler steps at the CFG batch of 28 with
  K4 on the long self-attention, and the temporal decode;
- an SDS step (``sds_trainer.sds_train_step``) on those splats in that
  view, with the SD-2-inpainting prior at full width in float32 (the
  UNet2D at the CFG batch of 2 with K4, the KL encoder forward and
  backward at 512x512), its draws from a generator as ``sds_train``'s.

Each unit runs once before it is audited (kernel build, first
allocations), and with telemetry off and on (device events). Marked
``cuda``: without a GPU every test skips. No JAX is imported:

    python -m pytest --noconftest -m cuda tests/test_torch_sync_audit.py
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from multiview_inpaint_tpu_torch import telemetry
from multiview_inpaint_tpu_torch.gs import cameras, gaussians
from multiview_inpaint_tpu_torch.models import gs_trainer
from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera, api


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync debug mode is CUDA's")


@pytest.fixture(params=[False, True], ids=["spans_off", "spans_on"])
def audit(request, monkeypatch):
    """``audit(fn)``: ``fn()`` once, then again under the sync debug mode
    with the mode lifted inside ``host_read`` spans; ``audit.reads`` is
    the number of ``host_read`` spans the audited call entered."""
    _require_cuda()

    @contextlib.contextmanager
    def lifted():
        run.reads += 1
        torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(telemetry, "host_read", lifted)
    if request.param:
        telemetry.reset()
        telemetry.enable(device_events=True)

    def run(fn):
        fn()
        torch.cuda.synchronize()
        run.reads = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()

    run.reads = 0
    yield run
    telemetry.disable()
    telemetry.reset()


N_SPLATS, SH_DEGREE, WIDTH, HEIGHT = 2_000_000, 3, 1920, 1080
FRAMES, SIZE = 14, (512, 384)


@pytest.fixture(scope="module")
def splats():
    """The scene, SH degree 3 with rest coefficients, and the view."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.utils import synthetic
    p = synthetic.make_big_scene(N_SPLATS, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    m = (SH_DEGREE + 1) ** 2 - 1
    p = dataclasses.replace(p, features_rest=0.05 * torch.randn(
        (N_SPLATS, m, 3), generator=g, device="cuda"))
    cam = RenderCamera.from_camera(
        cameras.make_camera(0, np.eye(3), np.array([0.0, 0, 3.0]),
                            fovx=1.1, fovy=0.7, width=WIDTH, height=HEIGHT),
        "cuda")
    return p, cam


@pytest.mark.cuda
def test_render_waits_only_in_host_reads(splats, audit):
    p, cam = splats
    bg = torch.zeros(3, device="cuda")
    with torch.no_grad():
        out = audit(lambda: api.render(p, cam, bg, sh_degree=SH_DEGREE,
                                       device="cuda"))
    assert out.pairs > 0
    # The binning's two (the pair total, the tile histogram's range); the
    # projection, one K6 launch, waits for nothing.
    assert audit.reads == 2


@pytest.mark.cuda
def test_train_step_waits_only_in_host_reads(splats, audit):
    p, cam = splats
    bg = torch.zeros(3, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    gt = torch.rand((HEIGHT, WIDTH, 3), generator=g, device="cuda")
    cfg = gs_trainer.OptimizationConfig()
    state = {"s": gs_trainer.init_state(p)}

    def step():
        state["s"], m = gs_trainer.train_step(state["s"], cam, gt, bg, cfg,
                                              3.0, sh_degree=SH_DEGREE)
        return m

    assert audit(step).pairs > 0
    # the binning's two; the projection (K6, then K7 in the backward)
    # waits for nothing
    assert audit.reads == 2


@pytest.fixture(scope="module")
def svd_engine():
    _require_cuda()
    from multiview_inpaint_tpu_torch.diffusion import engine
    cfg = engine.EngineConfig(num_frames=FRAMES, num_steps=2,
                              compute_dtype="bfloat16")
    return engine.init_engine(cfg, seed=0, device="cuda",
                              param_dtype=torch.bfloat16)


@pytest.mark.cuda
def test_svd_clip_waits_only_in_host_reads(svd_engine, audit):
    from multiview_inpaint_tpu_torch.diffusion import attention_op
    eng, t, (h, w) = svd_engine, FRAMES, SIZE
    assert attention_op.routes_to_flash((h // 8) * (w // 8),
                                        (h // 8) * (w // 8), 64)
    g = torch.Generator(device="cuda").manual_seed(1)
    frame = torch.rand((1, h, w, 3), generator=g, device="cuda") * 2 - 1
    one = torch.ones((1,), device="cuda")
    batch = {"cond_frames_without_noise": frame, "cond_frames": frame,
             "fps_id": 6.0 * one, "motion_bucket_id": 127.0 * one,
             "cond_aug": 0.0 * one,
             "control_hint": torch.rand((t, h, w, 7), generator=g,
                                        device="cuda")}
    noise = torch.randn((t, h // 8, w // 8, 4), generator=g, device="cuda")
    aug = torch.randn(frame.shape, generator=g, device="cuda")

    def clip():
        c = eng.prepare_cond(batch, aug_noise=aug)
        uc = eng.prepare_cond(batch, unconditional=True)
        uc["control_hint"] = c["control_hint"]
        z = eng.sample(c, uc, latent_shape=noise.shape, noise=noise)
        return eng.decode_first_stage(z, timesteps=t)

    with torch.no_grad():
        frames = audit(clip)
    assert frames.shape == (t, h, w, 3)
    assert torch.isfinite(frames).all()


@pytest.fixture(scope="module")
def sds_prior():
    _require_cuda()
    from multiview_inpaint_tpu_torch.diffusion.unet2d import (UNet2D,
                                                              UNet2DConfig)
    from multiview_inpaint_tpu_torch.diffusion.vae import (AutoencoderKL,
                                                           VAEConfig)
    from multiview_inpaint_tpu_torch.pipelines.sds_train import make_guidance
    torch.manual_seed(0)
    return make_guidance(UNet2D(UNet2DConfig(), device="cuda"),
                         AutoencoderKL(VAEConfig(), video_decoder=False,
                                       device="cuda"), 100.0)


@pytest.mark.cuda
def test_sds_step_waits_only_in_host_reads(splats, sds_prior, audit):
    from multiview_inpaint_tpu_torch.models import sds_trainer
    p, cam = splats
    bg = torch.zeros(3, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    gt = torch.rand((HEIGHT, WIDTH, 3), generator=g, device="cuda")
    mask = torch.zeros((HEIGHT, WIDTH), device="cuda")
    mask[340:740, 760:1160] = 1.0
    embs = torch.randn((2, 77, 1024), generator=g, device="cuda")
    state = {"s": gs_trainer.init_state(p)}

    def step():
        state["s"], m = sds_trainer.sds_train_step(
            state["s"], cam, gt, mask, bg, gs_trainer.INPAINT_OPT,
            sds_prior, embs, spatial_lr_scale=3.0, sh_degree=SH_DEGREE,
            generator=g)
        return m

    assert audit(step).pairs > 0
    # the render's two (the pair total, the tile histogram's range); the
    # mask's nearest resizes make their indices on the card
    assert audit.reads == 2
