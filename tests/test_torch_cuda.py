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


@pytest.mark.cuda
def test_cuda_composite_backward_raises():
    _require_cuda()
    p = _scene(50).to("cuda")
    p.opacity.requires_grad_(True)
    out = render(p, RenderCamera.from_camera(_camera(), "cuda"), BG,
                 device="cuda")
    with pytest.raises(NotImplementedError, match="K3"):
        out.rgb.sum().backward()
