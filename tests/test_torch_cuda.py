"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU every test skips. This file imports torch
and the port only (no JAX), so on a machine with the card and no JAX it
runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from multiview_inpaint_tpu_torch.diffusion import flash_attention as fa
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


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 16), (8, 16)])
def test_cuda_composite_launch_orders_agree(tile):
    """K2 on a 20k-gaussian bench frame in tile order and deepest tiles
    first: bit-equal tiles either way and with the per-item state, within
    rgb 3e-5 / depth 3e-4 of the plain K2 on all but 0.01% of pixels."""
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
        args = (attrs, bins.seg_start, bins.counts, tx, ty, th, tw)
        tiles = composite_cuda._launch(*args, False, by_depth=False)
        deep, state = composite_cuda._launch(*args, True, by_depth=True)
        want = composite.composite_segments(*args)
    assert torch.equal(tiles, deep)
    assert state.shape[0] == composite.max_items(tx * ty, attrs.shape[0])
    err_rgb = (tiles[:, :3] - want[:, :3]).abs().amax(1)
    err_d = (tiles[:, 3] - want[:, 3]).abs()
    bad = (err_rgb > RGB_TOL) | (err_d > DEPTH_TOL)
    assert int(bad.sum()) <= 1e-4 * bad.numel()


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
        tiles8, state = composite_cuda.composite_fwd(*args, *size,
                                                     with_state=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        g = torch.randn(tiles8.shape, generator=gen, device="cuda")
        g[:, 5:] = 0
        got = composite_cuda.composite_bwd(*args, tiles8, g, *size, state)
        again = composite_cuda.composite_bwd(*args, tiles8, g, *size,
                                             state)
        want = composite.composite_segments_bwd(*args, tiles8, g, *size)
    assert bins.total_pairs > 0 and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _k3_bar_share(got[:, :10], want[:, :10]) <= 1e-4
    assert not got[:, 10:].any()


def _state_share(got, want):
    """Share of item-pixels whose carried T or rgb accumulators differ by
    more than 3e-5, or whose depth accumulator differs by more than 3e-4
    (a state [items, 5, PIX])."""
    bad = (((got[:, 0:4] - want[:, 0:4]).abs() > RGB_TOL).any(dim=1)
           | ((got[:, 4] - want[:, 4]).abs() > DEPTH_TOL))
    return float(bad.float().mean())


def _item_frame(counts, tile, seed=0):
    """Packed attrs on the card of faint splats over a row of tiles of
    shape ``tile`` (h, w), tile t's segment ``counts[t]`` pairs long: the
    pixels of a deep tile see through several items."""
    th, tw = tile
    rng = np.random.default_rng(seed)
    tile_of = np.repeat(np.arange(len(counts)), counts)
    n = tile_of.size
    means = np.stack([tile_of * tw + rng.uniform(-4, tw + 4, n),
                      rng.uniform(-4, th + 4, n)], -1)
    sx, sy = rng.uniform(2, 8, n), rng.uniform(2, 8, n)
    rho = rng.uniform(-0.5, 0.5, n)
    det = (1 - rho ** 2) * sx ** 2 * sy ** 2
    conic = np.stack([sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det],
                     -1)
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite_cuda
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    attrs = composite_cuda.pack_attrs(
        f(means), f(conic), f(rng.uniform(0.005, 0.03, n)),
        f(rng.uniform(0, 1, (n, 3))), f(rng.uniform(1, 5, n))).contiguous()
    counts = torch.tensor(counts, dtype=torch.int64, device="cuda")
    return attrs, torch.cumsum(counts, 0) - counts, counts


def _item_counts():
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite
    m = composite.ITEM_PAIRS
    return [m - 1, m, m + 1, 0, 2 * m - 1, 2 * m, 2 * m + 1, 1, 127, 128,
            129, 0, 5 * m + 17]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 16), (8, 16)])
def test_cuda_k3_items_at_boundaries_and_deep_tiles(tile):
    """Tiles deeper than several items, counts at item boundaries +- 1,
    empty tiles: K2's tiles are bit-equal with and without the per-item
    state, that state matches the plain K2's at K2's bars, and K3 from it
    matches the plain K3 walking each tile from its start and the plain
    K3 from the same state at the gradient bar, repeats bit for bit and
    leaves rows 10-15 at 0."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.ops.rasterizer import (composite,
                                                            composite_cuda)
    counts = _item_counts()
    attrs, seg_start, cnt = _item_frame(counts, tile)
    size = (len(counts), 1, *tile)
    with torch.no_grad():
        bare = composite_cuda.composite_fwd(attrs, seg_start, cnt, *size)
        tiles8, state = composite_cuda.composite_fwd(
            attrs, seg_start, cnt, *size, with_state=True)
        _, state_p = composite.composite_segments(
            attrs, seg_start, cnt, *size, with_state=True)
        gen = torch.Generator(device="cuda").manual_seed(1)
        g = torch.randn(tiles8.shape, generator=gen, device="cuda")
        g[:, 5:] = 0
        args = (attrs, seg_start, cnt, tiles8, g, *size, state)
        got = composite_cuda.composite_bwd(*args)
        again = composite_cuda.composite_bwd(*args)
        want = composite.composite_segments_bwd(*args)
        walk = composite.composite_segments_bwd(*args[:-1])
    assert torch.equal(bare, tiles8)
    # Every item's first row of T is K2's carry into it: 1 at a tile's
    # first item, below 1 further in (the pixels see through).
    ends = composite.item_ends(cnt)
    n_items = int(ends[-1])
    assert n_items == sum(-(-c // composite.ITEM_PAIRS) for c in counts)
    assert _state_share(state[:n_items], state_p[:n_items]) <= 1e-4
    first = ends - (cnt + composite.ITEM_PAIRS - 1) // composite.ITEM_PAIRS
    deep = len(counts) - 1
    assert torch.equal(state[int(first[deep]), 0],
                       torch.ones_like(state[0, 0]))
    assert float(state[int(first[deep]) + 1, 0].max()) < 1.0
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert _k3_bar_share(got[:, :10], want[:, :10]) <= 1e-4
    assert _k3_bar_share(got[:, :10], walk[:, :10]) <= 1e-4
    assert not got[:, 10:].any() and float(want[:, :10].abs().max()) > 0


@pytest.mark.cuda
def test_cuda_k3_all_empty_and_no_pairs():
    """A frame without pairs: K2 writes T = 1, K3 returns [0, 16]."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite_cuda
    attrs, seg_start, cnt = _item_frame([0, 0, 0], (16, 16))
    size = (3, 1, 16, 16)
    tiles8, state = composite_cuda.composite_fwd(attrs, seg_start, cnt,
                                                 *size, with_state=True)
    assert torch.equal(tiles8[:, 4], torch.ones_like(tiles8[:, 4]))
    d = composite_cuda.composite_bwd(attrs, seg_start, cnt, tiles8,
                                     torch.ones_like(tiles8), *size, state)
    assert d.shape == (0, 16)


@pytest.mark.cuda
def test_cuda_k3_refuses_a_missing_state():
    _require_cuda()
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite_cuda
    attrs, seg_start, cnt = _item_frame([5, 300], (16, 16))
    size = (2, 1, 16, 16)
    tiles8 = composite_cuda.composite_fwd(attrs, seg_start, cnt, *size)
    with pytest.raises(ValueError, match="state"):
        composite_cuda.composite_bwd(attrs, seg_start, cnt, tiles8,
                                     torch.ones_like(tiles8), *size)


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
@pytest.mark.parametrize("t", [768, 256])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype,bar", [(torch.bfloat16, 0.02),
                                       (torch.float32, 0.02)])
def test_cuda_flash_attention_matches_plain_k4(dtype, bar, d, t):
    """K4 against its plain version at unit-normal inputs, every head dim
    the wrapper takes, two sequence lengths: within the JAX test's 0.02
    (bf16 rounding of p, and of q, k, v for f32 inputs), the [B, T, H*D]
    layout bit-equal to the folded one, and bit for bit from one run to
    the next."""
    _require_cuda()
    from multiview_inpaint_tpu_torch import kernels
    gen = torch.Generator(device="cuda").manual_seed(d + t)
    q, k, v = (torch.randn((2, t, 2 * d), generator=gen,
                           device="cuda").to(dtype) for _ in range(3))
    scale = d ** -0.5
    before = kernels.LAUNCHES["flash_attn_fwd"]
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, 2, scale)
        again = fa.flash_attention(q, k, v, 2, scale)
        want = fa.flash_attention_ref(q, k, v, 2, scale)

        def fold(x):
            return x.reshape(2, t, 2, d).transpose(1, 2).reshape(
                4, t, d).contiguous()
        folded, lse = fa.flash_mha(fold(q), fold(k), fold(v), scale,
                                   save_lse=True)
    assert kernels.LAUNCHES["flash_attn_fwd"] == before + 3
    assert got.dtype == dtype and torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) < bar
    assert torch.equal(fold(got), folded)
    s = torch.einsum("bqd,bkd->bqk", fold(q).float(), fold(k).float())
    assert float((lse - torch.logsumexp(s * scale, -1)).abs().max()) < 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40])
def test_cuda_attention_pads_head_dims_for_k4_and_k5(d):
    """A head dim the kernels do not take, through ``attention_op`` on
    CUDA at T = 768: zero-padded to the next of ``HEAD_DIMS`` for K4 and
    K5 (one launch each) at the true d^-0.5 scale, the output within K4's
    0.02 and the gradients within K5's bars (0.02 of max|plain|, 0.01
    relative rms) of the plain unpadded attention."""
    _require_cuda()
    from multiview_inpaint_tpu_torch import kernels
    from multiview_inpaint_tpu_torch.diffusion import attention_op
    b, t, h = 2, 768, 2
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn((b, t, h * d), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    kernels.reset_launches()
    out = attention_op.attention(qa, ka, va, h)
    grads = torch.autograd.grad(out, (qa, ka, va), do)
    assert kernels.LAUNCHES["flash_attn_fwd"] == 1
    assert kernels.LAUNCHES["flash_attn_bwd"] == 1
    qb, kb, vb = (x.clone().requires_grad_() for x in (q, k, v))
    want = fa.flash_attention_ref(qb, kb, vb, h, d ** -0.5)
    wants = torch.autograd.grad(want, (qb, kb, vb), do)
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    assert float((out.float() - want.float()).abs().max()) < 0.02
    for g, w in zip(grads, wants):
        err = g.float() - w.float()
        assert float(err.abs().max() / w.float().abs().max()) <= 0.02
        assert float(err.pow(2).mean().sqrt()
                     / w.float().pow(2).mean().sqrt()) <= 0.01


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2, 768, 2, 64), torch.bfloat16), ((1, 256, 1, 128), torch.bfloat16),
    ((2, 256, 3, 32), torch.float32)] + [
    ((1, 384, 2, d), dtype) for d in fa.HEAD_DIMS
    for dtype in (torch.bfloat16, torch.float32)])
def test_cuda_flash_attention_backward_matches_plain_k5(shape, dtype):
    """K5 against its plain version at unit-normal inputs, o and the
    logsumexp from K4, every head dim the wrapper takes: dq, dk, dv within
    0.02 of max|plain| and 0.01 relative rms (the bars of chip_smoke.py's
    phase 16), bit for bit from one run to the next and bit-equal to K5 on
    the folded [B*H, T, D] layout, one count per call; and the gradient
    through ``attention_op`` on CUDA goes through K4 and K5."""
    _require_cuda()
    from multiview_inpaint_tpu_torch import kernels
    from multiview_inpaint_tpu_torch.diffusion import attention_op
    b, t, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(t + d)
    q, k, v, do = (torch.randn((b, t, h * d), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    scale = d ** -0.5
    with torch.no_grad():
        o, lse = fa._launch(q, k, v, h, scale, True)
        before = kernels.LAUNCHES["flash_attn_bwd"]
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, h, scale)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, h, scale)
        assert kernels.LAUNCHES["flash_attn_bwd"] == before + 2
        want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, h, scale)
        folded = fa.flash_attention_bwd(
            *(fa._fold(x, h).contiguous() for x in (q, k, v, o)), lse,
            fa._fold(do, h).contiguous(), 1, scale)
    for g, a, w, f in zip(got, again, want, folded):
        assert g.dtype == dtype and torch.equal(g, a)
        assert torch.equal(fa._fold(g, h), f)
        err = (g.float() - w.float())
        assert float(err.abs().max() / w.float().abs().max()) <= 0.02
        assert float(err.pow(2).mean().sqrt()
                     / w.float().pow(2).mean().sqrt()) <= 0.01
    if t % 256 == 0 and t >= 768:
        qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
        kernels.reset_launches()
        out = attention_op.attention(qa, ka, va, h)
        grads = torch.autograd.grad(out, (qa, ka, va), do)
        assert kernels.LAUNCHES["flash_attn_fwd"] == 1
        assert kernels.LAUNCHES["flash_attn_bwd"] == 1
        for g, w in zip(grads, got):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_tiny_svd_train_step_matches_cpu():
    """One train step of the tiny SVD engine (svd_train --tiny_model, 3
    frames at 64x48, f32, TF32 off) on CUDA against the CPU with the same
    weights, data, sigma and noise (the bars of chip_smoke.py's phase 18):
    loss within 1e-4 relative, ControlNet gradients within 1e-4 of their
    tensor's max|g| + 1e-7, parameters after one Adam step within 1e-3 lr
    where |g| >= 1e-6."""
    _require_cuda()
    import argparse

    from multiview_inpaint_tpu_torch.diffusion import engine
    from multiview_inpaint_tpu_torch.parallel import svd_data_parallel as dp
    from multiview_inpaint_tpu_torch.pipelines import svd_train
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = svd_train._engine_config(argparse.Namespace(
            tiny_model=True, num_frames=3, pose_cond=False, warp_loss=False))
        cpu = engine.init_engine(cfg, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in cpu.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        gpu = engine.init_engine(cfg, seed=1, device="cuda")
        gpu.load_reference_state_dict(cpu.reference_state_dict())
        rng = np.random.default_rng(2)
        cond = {"crossattn": rng.normal(size=(1, 3, 1, 16)),
                "vector": rng.normal(size=(1, 3, 768)),
                "concat": rng.normal(size=(1, 3, 8, 6, 4)),
                "control_hint": rng.uniform(size=(1, 3, 64, 48, 7))}
        lat = rng.normal(size=(1, 3, 8, 6, 4))
        noise = rng.normal(size=(1, 3, 8, 6, 4))
        runs = []
        for eng, dev in ((cpu, "cpu"), (gpu, "cuda")):
            def t(x):
                return torch.tensor(x, dtype=torch.float32, device=dev)
            params = dp.trainable_params(eng)
            opt = dp.build_optimizer(1e-4)
            state = opt.init(params)
            loss = dp.make_train_step(eng, opt, params)(
                state, {}, t(lat), {k: t(v) for k, v in cond.items()},
                sigmas=t([1.7]), noise=t(noise))
            # the first moment after one step is 0.1 g
            runs.append((float(loss),
                         {k: p.detach().cpu() for k, p in params.items()},
                         {k: m.cpu() / 0.1 for k, m in state["mu"].items()}))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    (l0, p0, g0), (l1, p1, g1) = runs
    assert abs(l1 - l0) <= 1e-4 * abs(l0)
    for k in g0:
        assert float((g1[k] - g0[k]).abs().max()) <= (
            1e-4 * float(g0[k].abs().max()) + 1e-7), k
        big = g0[k].abs() >= 1e-6
        if big.any():
            assert float((p1[k] - p0[k]).abs()[big].max()) <= 1e-7, k


@pytest.mark.cuda
def test_cuda_foreach_adam_and_ema_equal_per_tensor_ops():
    """Adam and the EMA update run as foreach ops on the card: bit for bit
    the per-tensor ops of optax's order (bf16 constants, each op rounded
    to bf16), over two steps of bf16 tensors of several shapes."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.parallel import svd_data_parallel as dp
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(320, 320), (7,), (4, 4, 3, 3), (1280,)]
    params = {f"p{i}": (0.02 * torch.randn(s, generator=gen, device="cuda")
                        ).to(torch.bfloat16) for i, s in enumerate(shapes)}
    ref = {k: p.clone() for k, p in params.items()}
    ema, ema_ref = ({k: p.clone() for k, p in params.items()}
                    for _ in range(2))
    opt = dp.build_optimizer(1e-4)
    state = opt.init(params)
    mu, nu = ({k: torch.zeros_like(p) for k, p in ref.items()}
              for _ in range(2))

    def c(x):
        return torch.tensor(float(x), dtype=torch.bfloat16, device="cuda")

    for count in (1, 2):
        grads = {k: torch.randn(p.shape, generator=gen, device="cuda").to(
            torch.bfloat16) * 1e-3 for k, p in params.items()}
        opt.step(params, grads, state)
        dp.ema_update(ema, params, 0.9999)
        bc1 = np.float32(1) - np.float32(dp.B1) ** np.float32(count)
        bc2 = np.float32(1) - np.float32(dp.B2) ** np.float32(count)
        for k, p in ref.items():
            g = grads[k]
            mu[k] = c(1 - dp.B1) * g + c(dp.B1) * mu[k]
            nu[k] = c(1 - dp.B2) * (g * g) + c(dp.B2) * nu[k]
            upd = (mu[k] / c(bc1)) / (torch.sqrt(nu[k] / c(bc2) + c(0.0))
                                      + c(dp.EPS))
            ref[k] = p + c(-np.float32(1e-4)) * upd
            ema_ref[k] = c(0.9999) * ema_ref[k] + c(1 - 0.9999) * ref[k]
        for k in params:
            assert torch.equal(params[k], ref[k]), k
            assert torch.equal(state["mu"][k], mu[k]), k
            assert torch.equal(ema[k], ema_ref[k]), k


@pytest.mark.cuda
def test_cuda_tiny_unet2d_and_controlnet2d_match_cpu():
    """The tiny UNet2D and ControlNet2D of ``ctrl_inpaint --tiny`` at a
    64x64 latent (ds1 self-attention at T = 4096, 2 heads of 16: K4 on
    the card) on CUDA against the same weights on the CPU (plain
    attention), f32 with TF32 off, every leaf moved off its init: K4
    launched 6 times on the card (the ds1 encoder block and the middle
    block at T = 1024 in the trunk and in the UNet, and the UNet's two
    ds1 decoder blocks), none on the CPU; eps within chip_smoke.py's
    denoiser bar, 0.018 relative rms."""
    _require_cuda()
    import argparse

    from multiview_inpaint_tpu_torch import kernels
    from multiview_inpaint_tpu_torch.pipelines import ctrl_inpaint
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg, _ = ctrl_inpaint.configs(argparse.Namespace(tiny=True,
                                                         context_dim=16))
        from multiview_inpaint_tpu_torch.diffusion.controlnet2d import (
            ControlNet2D)
        from multiview_inpaint_tpu_torch.diffusion.unet2d import UNet2D
        torch.manual_seed(0)
        nets = {"cpu": (UNet2D(cfg), ControlNet2D(cfg))}
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for net in nets["cpu"]:
                for p in net.parameters():
                    p.add_(0.05 * torch.randn(p.shape, generator=gen))
        nets["cuda"] = tuple(UNet2D(cfg, device="cuda") if i == 0 else
                             ControlNet2D(cfg, device="cuda")
                             for i in range(2))
        for a, b in zip(nets["cpu"], nets["cuda"]):
            b.load_state_dict(a.state_dict())
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.normal(size=(2, 64, 64, 9)).astype(
            np.float32))
        hint = torch.from_numpy(rng.uniform(0, 1, (2, 512, 512, 3)).astype(
            np.float32))
        ctx = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(
            np.float32))
        t = torch.tensor([17.0, 503.0])
        outs = {}
        for dev, (unet, cnet) in nets.items():
            kernels.reset_launches()
            with torch.no_grad():
                args = [v.to(dev) for v in (x, t, ctx)]
                ctrl = cnet(args[0], hint.to(dev), args[1], args[2])
                outs[dev] = (unet(*args, control=ctrl).cpu(),
                             kernels.LAUNCHES["flash_attn_fwd"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    (a, n_cpu), (b, n_gpu) = outs["cpu"], outs["cuda"]
    assert (n_cpu, n_gpu) == (0, 6)
    rms = float((b - a).pow(2).mean().sqrt() / a.pow(2).mean().sqrt())
    assert rms <= 0.018, rms
