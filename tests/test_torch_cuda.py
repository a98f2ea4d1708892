"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU every test skips. This file imports torch
and the port only (no JAX), so on a machine with the card and no JAX it
runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from multiview_inpaint_tpu_torch.gs import cameras, gaussians
from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera, api,
                                                        binning,
                                                        pair_expand, render)
from multiview_inpaint_tpu_torch.utils import synthetic

RGB_TOL, DEPTH_TOL = 3e-5, 3e-4
BG = [0.1, 0.2, 0.3]


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _scene(n=400, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.5, 1.5, size=(n, 3))
    xyz[:, 2] = rng.uniform(-1.0, 3.0, size=n)
    return gaussians.from_arrays(
        xyz.astype(np.float32),
        rng.normal(size=(n, 1, 3)).astype(np.float32),
        np.zeros((n, 0, 3), np.float32),
        rng.normal(size=(n, 1)).astype(np.float32),
        np.log(rng.uniform(0.02, 0.15, size=(n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32), device="cpu")


def _camera():
    return cameras.make_camera(0, np.eye(3), np.array([0.0, 0, 4.0]),
                               fovx=0.8, fovy=0.7, width=96, height=64)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 16), (8, 16)])
def test_cuda_render_matches_cpu_render(tile):
    _require_cuda()
    p = _scene()
    with torch.no_grad():
        a = render(p, RenderCamera.from_camera(_camera(), "cpu"), BG,
                   tile=tile, device="cpu")
        b = render(p, RenderCamera.from_camera(_camera(), "cuda"), BG,
                   tile=tile, device="cuda")
    assert a.pairs == b.pairs > 0
    np.testing.assert_allclose(b.rgb.cpu().numpy(), a.rgb.numpy(),
                               atol=RGB_TOL)
    np.testing.assert_allclose(b.depth.cpu().numpy(), a.depth.numpy(),
                               atol=DEPTH_TOL)


@pytest.mark.cuda
def test_cuda_pair_keys_bit_exact():
    _require_cuda()
    big = synthetic.make_big_scene(20_000, device="cuda")
    cam = RenderCamera.from_camera(synthetic.bench_camera(), "cuda")
    with torch.no_grad():
        proj = api.project(big, cam, 0)
    r = binning.compact_rects(proj.means2d, proj.radius, proj.depth, 120,
                              68, 16, 16, proj.extent)
    args = (r.starts, r.x0, r.y0, r.w, r.count, r.n_active, r.total, 120)
    assert r.total > 0
    assert torch.equal(pair_expand.expand_keys(*args),
                       pair_expand.expand_keys_ref(*args))


def _k3_bar_share(got, want):
    """Share of pairs with a row beyond 2e-6 + 1e-4 max|row|."""
    bar = 2e-6 + 1e-4 * want.abs().amax(dim=0)
    return float(((got - want).abs() > bar).any(dim=1).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 16), (8, 16)])
def test_cuda_composite_backward_matches_plain_k3(tile):
    """K3 against its plain version on a 20k-gaussian bench frame: rows
    0-9 at 2e-6 + 1e-4 max|row| on all but 0.01% of pairs (a flipped
    gate or stop decision), rows 10-15 exactly 0, and bit for bit from
    one run to the next."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.ops.rasterizer import (composite,
                                                            composite_cuda)
    big = synthetic.make_big_scene(20_000, device="cuda")
    cam = RenderCamera.from_camera(synthetic.bench_camera(), "cuda")
    th, tw = tile
    tx, ty = -(-cam.width // tw), -(-cam.height // th)
    with torch.no_grad():
        proj = api.project(big, cam, 0)
        bins = binning.bin_gaussians(proj.means2d, proj.radius, proj.depth,
                                     tx, ty, tw, th, extent=proj.extent)
        attrs = composite_cuda.pack_attrs(
            proj.means2d, proj.conic, proj.opacity, proj.color,
            proj.depth)[bins.order[bins.gid_sorted]].contiguous()
        args = (attrs, bins.seg_start, bins.counts)
        size = (tx, ty, th, tw)
        tiles8 = composite_cuda.composite_fwd(*args, *size)
        gen = torch.Generator(device="cuda").manual_seed(0)
        g = torch.randn(tiles8.shape, generator=gen, device="cuda")
        g[:, 5:] = 0
        got = composite_cuda.composite_bwd(*args, tiles8, g, *size)
        again = composite_cuda.composite_bwd(*args, tiles8, g, *size)
        want = composite.composite_segments_bwd(*args, tiles8, g, *size)
    assert bins.total_pairs > 0 and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _k3_bar_share(got[:, :10], want[:, :10]) <= 1e-4
    assert not got[:, 10:].any()


def _train_scene(device):
    return synthetic.make_gt_gaussians(300, seed=3, spread=1.0, device=device)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu_train_step():
    _require_cuda()
    from multiview_inpaint_tpu_torch.models import gs_trainer
    cam = cameras.make_camera(0, np.eye(3), np.array([0.0, 0.0, 3.0]),
                              fovx=0.9, fovy=0.7, width=96, height=64)
    gt = np.random.default_rng(0).random((64, 96, 3)).astype(np.float32)
    cfg = gs_trainer.OptimizationConfig()
    runs = {}
    for dev in ("cpu", "cuda"):
        runs[dev] = gs_trainer.train_step(
            gs_trainer.init_state(_train_scene(dev)),
            RenderCamera.from_camera(cam, dev),
            torch.from_numpy(gt).to(dev), torch.tensor(BG, device=dev), cfg,
            1.0)
    (a, ma), (b, mb) = runs["cpu"], runs["cuda"]
    assert ma.pairs == mb.pairs > 0
    assert abs(float(ma.loss) - float(mb.loss)) <= 1e-5 * float(ma.loss)
    for f in ("xyz", "features_dc", "opacity", "scaling", "rotation"):
        want = a.mu[f] / 0.1                      # the gradient at step 1
        bar = 2e-6 + 1e-4 * float(want.abs().max())
        assert float((b.mu[f].cpu() / 0.1 - want).abs().max()) <= bar, f
    bar = 2e-6 + 1e-4 * float(a.stats.grad_accum.abs().max())
    assert float((b.stats.grad_accum.cpu() - a.stats.grad_accum)
                 .abs().max()) <= bar
    assert torch.equal(b.stats.max_radii2d.cpu(), a.stats.max_radii2d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bar", [(torch.bfloat16, 0.02),
                                       (torch.float32, 0.02)])
def test_cuda_flash_attention_matches_plain_k4(dtype, bar):
    """K4 against its plain version at unit-normal inputs: within the
    JAX test's 0.02 (bf16 rounding of p, and of q, k, v for f32 inputs),
    the [B, T, H*D] layout equal to the folded one, and bit for bit from
    one run to the next."""
    _require_cuda()
    from multiview_inpaint_tpu_torch import kernels
    from multiview_inpaint_tpu_torch.diffusion import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 768, 2 * 64), generator=gen,
                           device="cuda").to(dtype) for _ in range(3))
    before = kernels.LAUNCHES["flash_attn_fwd"]
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, 2, 0.125)
        again = fa.flash_attention(q, k, v, 2, 0.125)
        want = fa.flash_attention_ref(q, k, v, 2, 0.125)

        def fold(x):
            return x.reshape(2, 768, 2, 64).transpose(1, 2).reshape(
                4, 768, 64).contiguous()
        folded, lse = fa.flash_mha(fold(q), fold(k), fold(v), 0.125,
                                   save_lse=True)
    assert kernels.LAUNCHES["flash_attn_fwd"] == before + 3
    assert got.dtype == dtype and torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) < bar
    assert torch.equal(fold(got), folded)
    s = torch.einsum("bqd,bkd->bqk", fold(q).float(), fold(k).float())
    assert float((lse - torch.logsumexp(s * 0.125, -1)).abs().max()) < 0.02


@pytest.mark.cuda
def test_cuda_tiny_svd_engine_matches_cpu():
    """The tiny SVD engine (svd_test --tiny_model, 3 frames at 64x48) on
    CUDA against the same weights on the CPU, every zero-initialised layer
    moved off zero, f32 with TF32 off (the bars of chip_smoke.py's phase
    13): the conditioning, and one set of latents decoded on both, within
    1e-4 of their largest magnitude; the latents of a 2-step sample within
    1e-4 of theirs plus 4 f32 spacings at each entry's |x0| (the first
    Euler step cancels x0 = 700 * noise down to the denoised latents)."""
    _require_cuda()
    import argparse

    from multiview_inpaint_tpu_torch.diffusion import engine, samplers
    from multiview_inpaint_tpu_torch.pipelines import svd_test
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = svd_test._engine_config(argparse.Namespace(
            tiny_model=True, num_frames=3, num_steps=2))
        cpu = engine.init_engine(cfg, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in cpu.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        gpu = engine.init_engine(cfg, seed=1, device="cuda")
        gpu.load_reference_state_dict(cpu.reference_state_dict())
        rng = np.random.default_rng(2)
        frame = rng.uniform(-1, 1, (1, 64, 48, 3)).astype(np.float32)
        batch = {"cond_frames_without_noise": frame, "cond_frames": frame,
                 "fps_id": np.array([6.0], np.float32),
                 "motion_bucket_id": np.array([127.0], np.float32),
                 "cond_aug": np.array([0.0], np.float32),
                 "control_hint": rng.uniform(0, 1, (3, 64, 48, 7)).astype(
                     np.float32)}
        noise = torch.from_numpy(rng.normal(size=(3, 8, 6, 4)).astype(
            np.float32))
        outs = []
        for eng, dev in ((cpu, "cpu"), (gpu, "cuda")):
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            c = eng.prepare_cond(b)
            uc = eng.prepare_cond(b, unconditional=True)
            uc["control_hint"] = c["control_hint"]
            z = eng.sample(c, uc, noise=noise)
            z_cpu = z if dev == "cpu" else outs[0][1].to(dev)
            outs.append((c, z, eng.decode_first_stage(z_cpu, 3)))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    (c0, z0, f0), (c1, z1, f1) = outs
    for a, b in [(c0[k], c1[k]) for k in c0] + [(f0, f1)]:
        bar = 1e-4 * float(a.abs().max()) + 1e-6
        assert float((b.cpu() - a).abs().max()) <= bar
    x0 = samplers.prepare_x(noise, torch.tensor([cfg.sigma_max])).abs()
    spacing = torch.ldexp(torch.ones_like(x0), torch.frexp(x0).exponent - 24)
    assert ((z1.cpu() - z0).abs()
            <= 1e-4 * float(z0.abs().max()) + 4 * spacing).all()
