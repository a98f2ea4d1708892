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
