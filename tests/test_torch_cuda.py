"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU every test skips. This file imports torch
and the port only (no JAX), so on a machine with the card and no JAX it
runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import projection_cases as cases
from multiview_inpaint_tpu_torch import telemetry
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


def _assert_k6_matches_plain(got, want):
    """radius, extent and visibility equal; means2d zero on culled rows;
    the floats within 1e-6 relative (NaN where the plain path has NaN)."""
    vis = want.radius > 0
    assert torch.equal(got.radius, want.radius)
    assert torch.equal(got.extent, want.extent)
    assert torch.equal(got.radius > 0, vis)
    assert not got.means2d[~vis].any()
    for f in ("means2d", "conic", "depth", "color", "opacity"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, atol=0, equal_nan=True,
                                   msg=f"field {f}")


@pytest.mark.cuda
@pytest.mark.parametrize("scaling_modifier", [1.0, 0.6])
@pytest.mark.parametrize("sh_degree,max_sh_degree",
                         [(0, 0), (0, 3), (1, 3), (2, 3), (3, 3)])
def test_cuda_project_matches_plain(sh_degree, max_sh_degree,
                                    scaling_modifier):
    """K6 on the rows of every branch (behind the camera, at the near
    plane, at the fov clamp, dead, NaN, infinite, log-scale above 20)
    against its plain version on the card."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.ops.rasterizer import project_cuda
    p = cases.hard_scene(n=5000, max_sh_degree=max_sh_degree,
                         device="cuda")
    cam = RenderCamera.from_camera(cases.camera(), "cuda")
    with torch.no_grad():
        got = project_cuda.project(p, cam, sh_degree, scaling_modifier)
        want = project_cuda.project_ref(p, cam, sh_degree, scaling_modifier)
    assert bool((want.radius > 0).any())
    _assert_k6_matches_plain(got, want)


@pytest.mark.cuda
def test_cuda_project_matches_plain_on_a_bench_frame():
    """K6 on 200k splats of the bench scene at SH degree 3, 1080p."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.ops.rasterizer import project_cuda
    p = synthetic.with_sh_rest(
        synthetic.make_big_scene(200_000, device="cuda"), 3)
    cam = RenderCamera.from_camera(synthetic.bench_camera(), "cuda")
    with torch.no_grad():
        got = project_cuda.project(p, cam, 3)
        want = project_cuda.project_ref(p, cam, 3)
    _assert_k6_matches_plain(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [False, True], ids=["frame", "band"])
def test_cuda_render_through_k6_matches_plain_projection(band, monkeypatch):
    _require_cuda()
    from multiview_inpaint_tpu_torch.ops.rasterizer import project_cuda
    p = cases.hard_scene(n=5000, device="cuda")
    cam = RenderCamera.from_camera(cases.camera(), "cuda")
    kw = dict(band_rows=2, band_row0=1, band_stride=2) if band else {}
    with torch.no_grad():
        a = render(p, cam, BG, sh_degree=3, device="cuda", **kw)
        monkeypatch.setattr(api, "project", project_cuda.project_ref)
        b = render(p, cam, BG, sh_degree=3, device="cuda", **kw)
    assert a.pairs == b.pairs > 0
    assert torch.equal(a.radii, b.radii)
    np.testing.assert_allclose(a.rgb.cpu().numpy(), b.rgb.cpu().numpy(),
                               atol=RGB_TOL)
    np.testing.assert_allclose(a.depth.cpu().numpy(),
                               b.depth.cpu().numpy(), atol=DEPTH_TOL)


@pytest.mark.cuda
def test_cuda_render_launches_k6_only_without_gradient():
    """K6 once in every render on the card, K7 once in a backward, never
    the plain ops; a camera tensor that needs a gradient, which K7 does
    not write, is refused."""
    _require_cuda()
    p = cases.hard_scene(n=2000, device="cuda")
    cam = RenderCamera.from_camera(cases.camera(), "cuda")
    telemetry.reset()
    with torch.no_grad():
        render(p, cam, BG, sh_degree=3, device="cuda")
    counters = telemetry.snapshot()["counters"]
    assert counters["launch.project"] == 1
    assert counters.get("project.plain", 0) == 0
    telemetry.reset()
    leaf = dataclasses.replace(p, xyz=p.xyz.clone().requires_grad_(True))
    out = render(leaf, cam, BG, sh_degree=3, device="cuda")
    assert out.rgb.requires_grad
    out.rgb.sum().backward()
    counters = telemetry.snapshot()["counters"]
    assert counters.get("project.plain", 0) == 0
    assert counters["launch.project"] == counters["launch.project_bwd"] == 1
    telemetry.reset()
    moving = dataclasses.replace(
        cam, world_view=cam.world_view.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="camera tensor requires"):
        render(leaf, moving, BG, sh_degree=3, device="cuda")
    counters = telemetry.snapshot()["counters"]
    assert counters.get("project.plain", 0) == 0
    assert counters.get("launch.project", 0) == 0
    telemetry.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True], ids=["plain", "offset"])
def test_cuda_render_frame_bit_equal_with_and_without_gradient(offset):
    """The grad path's forward is K6's launch: a render with leaves (and a
    zero offset) gives the gradient-free frame bit for bit."""
    _require_cuda()
    p = synthetic.with_sh_rest(
        synthetic.make_big_scene(200_000, device="cuda"), 3)
    cam = RenderCamera.from_camera(synthetic.bench_camera(), "cuda")
    with torch.no_grad():
        want = render(p, cam, BG, sh_degree=3, device="cuda")
    leaf = dataclasses.replace(p, **{
        f: getattr(p, f).clone().requires_grad_(True)
        for f in ("xyz", "features_rest", "scaling")})
    off = (torch.zeros((p.capacity, 2), device="cuda", requires_grad=True)
           if offset else None)
    got = render(leaf, cam, BG, sh_degree=3, means2d_offset=off,
                 device="cuda")
    assert got.pairs == want.pairs > 0
    for f in ("rgb", "depth", "alpha", "radii"):
        assert torch.equal(getattr(got, f).detach(), getattr(want, f)), f


def _packed_cotangents(proj, seed=0):
    """The cotangents as column views of one [N, 16] buffer, as the packed
    attributes' gradient hands them to the projection."""
    g = torch.Generator(device=proj.radius.device).manual_seed(seed)
    vis = (proj.radius > 0)[:, None]
    buf = torch.randn((proj.radius.shape[0], 16), generator=g,
                      device=proj.radius.device) * vis
    return [buf[:, 0:2], buf[:, 2:5], buf[:, 9], buf[:, 6:9], buf[:, 5]]


def _assert_k7_matches_plain(got, want, vis, apart=()):
    """Culled rows 0; NaN where the plain version has NaN; finite entries
    within 1e-5 of the field's largest and 1e-4 relative, the rows
    ``apart`` (``grad_scene``'s row at a scale of e^20) each held to its
    own largest entry."""
    alone = torch.zeros_like(vis)
    alone[list(apart)] = True
    groups = [vis & ~alone] + [vis & (torch.arange(vis.shape[0],
                                                   device=vis.device) == r)
                               for r in apart]
    for f, a, b in zip(got._fields, got, want):
        if b is None:
            assert a is None, f
            continue
        assert not a[~vis].any() and not b[~vis].any(), f
        for rows in groups:
            x, y = a[rows], b[rows]
            assert torch.equal(torch.isnan(x), torch.isnan(y)), f
            fin = torch.isfinite(y)
            if y.numel() == 0 or not fin.any():
                continue
            bar = 1e-5 * float(y[fin].abs().max())
            torch.testing.assert_close(x[fin], y[fin], rtol=1e-4, atol=bar,
                                       msg=f"field {f}")


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["own", "packed"])
@pytest.mark.parametrize("scaling_modifier", [1.0, 0.6])
@pytest.mark.parametrize("sh_degree,max_sh_degree",
                         [(0, 0), (0, 3), (1, 3), (2, 3), (3, 3)])
def test_cuda_project_bwd_matches_plain(sh_degree, max_sh_degree,
                                        scaling_modifier, packed):
    """K7 on the rows of every branch (``projection_cases.grad_scene``)
    against its plain version on the card, the cotangents in tensors of
    their own or as strided columns of the packed gradient."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.ops.rasterizer import project_cuda
    p = cases.grad_scene(n=5000, max_sh_degree=max_sh_degree,
                         device="cuda")
    cam = RenderCamera.from_camera(cases.camera(), "cuda")
    with torch.no_grad():
        proj = project_cuda.project(p, cam, sh_degree, scaling_modifier)
    cots = _packed_cotangents(proj) if packed else cases.cotangents(proj)
    args = (p, cam, sh_degree, scaling_modifier, proj.radius, cots)
    got = project_cuda.project_bwd(*args)
    want = project_cuda.project_bwd_ref(*args)
    vis = proj.radius > 0
    assert bool(vis[[15, 17]].all())
    _assert_k7_matches_plain(got, want, vis, apart=(15,))


@pytest.mark.cuda
@pytest.mark.parametrize("n,sh_degree", [(2_000_000, 3), (100_000, 0)],
                         ids=["big2m_sh3", "100k_sh0"])
def test_cuda_project_bwd_matches_plain_on_a_bench_frame(n, sh_degree):
    """K7 on the bench scene in its 1080p view, with the offset's
    gradient, against its plain version."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.ops.rasterizer import project_cuda
    p = synthetic.make_big_scene(n, device="cuda")
    if sh_degree:
        p = synthetic.with_sh_rest(p, sh_degree)
    cam = RenderCamera.from_camera(synthetic.bench_camera(), "cuda")
    with torch.no_grad():
        proj = project_cuda.project(p, cam, sh_degree)
    args = (p, cam, sh_degree, 1.0, proj.radius, _packed_cotangents(proj))
    got = project_cuda.project_bwd(*args)
    want = project_cuda.project_bwd_ref(*args)
    _assert_k7_matches_plain(got, want, proj.radius > 0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("row0,stride", [(1, 3), (2, 1)])
def test_cuda_band_mode_k2_k3_match_plain_and_full_frame(row0, stride):
    """K2 and K3 in band mode (the band's tile rows row0 + l * stride of
    a 20k-gaussian bench frame) against their plain versions with the
    same origin, at K2's and K3's bars; the band's K2 tiles bit-equal to
    the same tiles of the full frame; a band render's rows bit-equal to
    the full render's and its pairs the band's share of the frame's."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.ops.rasterizer import (composite,
                                                            composite_cuda)
    big = synthetic.make_big_scene(20_000, device="cuda")
    cam = RenderCamera.from_camera(synthetic.bench_camera(), "cuda")
    th = tw = 16
    tx, ty_total = -(-cam.width // tw), -(-cam.height // th)
    rows = -(-(ty_total - row0) // stride)
    with torch.no_grad():
        proj = api.project(big, cam, 0)
        packed = composite_cuda.pack_attrs(proj.means2d, proj.conic,
                                           proj.opacity, proj.color,
                                           proj.depth)
        full = binning.bin_gaussians(proj.means2d, proj.radius, proj.depth,
                                     tx, ty_total, tw, th,
                                     extent=proj.extent)
        bins = binning.bin_gaussians(proj.means2d, proj.radius, proj.depth,
                                     tx, rows, tw, th, extent=proj.extent,
                                     tile_row0=row0, tiles_y_total=ty_total,
                                     tile_row_stride=stride)
        attrs_f = packed[full.order[full.gid_sorted]].contiguous()
        attrs = packed[bins.order[bins.gid_sorted]].contiguous()
        args = (attrs, bins.seg_start, bins.counts)
        size = (tx, rows, th, tw)
        band = dict(row0=row0, stride=stride)
        tiles8, state = composite_cuda.composite_fwd(
            *args, *size, with_state=True, **band)
        want = composite.composite_segments(*args, *size, **band)
        whole = composite_cuda.composite_fwd(
            attrs_f, full.seg_start, full.counts, tx, ty_total, th, tw)
        gen = torch.Generator(device="cuda").manual_seed(0)
        g = torch.randn(tiles8.shape, generator=gen, device="cuda")
        g[:, 5:] = 0
        got = composite_cuda.composite_bwd(*args, tiles8, g, *size, state,
                                           **band)
        want_bwd = composite.composite_segments_bwd(*args, tiles8, g, *size,
                                                    None, **band)
        out = render(big, cam, BG, band_rows=rows, band_row0=row0,
                     band_stride=stride, device="cuda")
        ref = render(big, cam, BG, device="cuda")
    assert bins.total_pairs > 0
    err_rgb = (tiles8[:, :3] - want[:, :3]).abs().amax(1)
    err_d = (tiles8[:, 3] - want[:, 3]).abs()
    bad = (err_rgb > RGB_TOL) | (err_d > DEPTH_TOL)
    assert int(bad.sum()) <= 1e-4 * bad.numel()
    glob = torch.arange(rows, device="cuda") * stride + row0
    tiles = (glob[:, None] * tx + torch.arange(tx, device="cuda")).reshape(-1)
    assert torch.equal(tiles8, whole[tiles])
    assert _k3_bar_share(got[:, :10], want_bwd[:, :10]) <= 1e-4
    assert not got[:, 10:].any()
    for l, gy in enumerate(glob.tolist()):
        lo, hi = gy * th, min((gy + 1) * th, cam.height)
        assert torch.equal(out.rgb[l * th:l * th + hi - lo], ref.rgb[lo:hi])
    assert out.pairs == bins.total_pairs < ref.pairs


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


def _grad_step_inputs(device):
    """An SH-3 scene of 2,000 anisotropic, rotated splats, a 96x64 view
    and its target, the first step's state."""
    from multiview_inpaint_tpu_torch.models import gs_trainer
    scene = synthetic.with_sh_rest(synthetic.make_gt_gaussians(
        2000, seed=3, spread=1.0, device=device), 3)
    g = torch.Generator(device=device).manual_seed(4)
    scene = dataclasses.replace(
        scene, rotation=torch.randn(scene.rotation.shape, generator=g,
                                    device=device),
        scaling=scene.scaling + 0.5 * torch.randn(
            scene.scaling.shape, generator=g, device=device))
    cam = cameras.make_camera(0, np.eye(3), np.array([0.0, 0.0, 3.0]),
                              fovx=0.9, fovy=0.7, width=96, height=64)
    gt = torch.rand((64, 96, 3), generator=g, device=device)
    return (gs_trainer.init_state(scene), RenderCamera.from_camera(cam,
                                                                  device),
            gt)


def _steps_through_k7_and_plain(monkeypatch, step):
    """``step()`` with the projection through K6 and K7, then through the
    plain ops on the card; each with its counters."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import project_cuda

    def plain(*args):
        telemetry.count("project.plain")
        return project_cuda.project_ref(*args)

    runs = []
    for kernel in (True, False):
        if not kernel:
            monkeypatch.setattr(project_cuda, "project_grad", plain)
        telemetry.reset()
        runs.append((*step(), telemetry.snapshot()["counters"]))
    telemetry.reset()
    (fused, m_fused, c_fused), (plain, m_plain, c_plain) = runs
    assert c_fused["launch.project_bwd"] == 1
    assert c_fused.get("project.plain", 0) == 0
    assert c_plain["project.plain"] == 1
    assert c_plain.get("launch.project_bwd", 0) == 0
    assert float(m_fused.loss) == float(m_plain.loss)
    assert int(m_fused.nonfinite_grads) <= int(m_plain.nonfinite_grads)
    for f in ("xyz", "features_dc", "features_rest", "opacity", "scaling",
              "rotation"):
        a, b = fused.mu[f] / 0.1, plain.mu[f] / 0.1   # the gradients
        fin = torch.isfinite(b)
        bar = 1e-5 * float(b[fin].abs().max())
        assert float((a - b)[fin].abs().max()) <= bar, f
    bar = 1e-5 * float(plain.stats.grad_accum.abs().max())
    assert float((fused.stats.grad_accum - plain.stats.grad_accum)
                 .abs().max()) <= bar
    assert torch.equal(fused.stats.max_radii2d, plain.stats.max_radii2d)


@pytest.mark.cuda
def test_cuda_train_step_through_k7_matches_plain_projection(monkeypatch):
    _require_cuda()
    from multiview_inpaint_tpu_torch.models import gs_trainer
    state, cam, gt = _grad_step_inputs("cuda")
    bg = torch.tensor(BG, device="cuda")
    _steps_through_k7_and_plain(monkeypatch, lambda: gs_trainer.train_step(
        state, cam, gt, bg, gs_trainer.OptimizationConfig(), 1.0,
        sh_degree=3))


@pytest.mark.cuda
def test_cuda_sds_step_through_k7_matches_plain_projection(monkeypatch):
    """The SDS step with a prior of an identity VAE and an eps of a point
    mass at a disk (no network), its draws fixed."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.guidance import sds
    from multiview_inpaint_tpu_torch.models import gs_trainer, sds_trainer
    state, cam, gt = _grad_step_inputs("cuda")
    size = 32
    yy, xx = torch.meshgrid(torch.arange(size), torch.arange(size),
                            indexing="ij")
    disk = (((yy - size / 2) ** 2 + (xx - size / 2) ** 2)
            < (size * 0.3) ** 2).float().cuda()
    latent = torch.cat([torch.stack([disk] * 3, -1) * 0.9 + 0.05,
                        torch.zeros((size, size, 1), device="cuda")], -1)
    acp = sds.DDPMSchedule().alphas_cumprod().cuda()

    def eps(x9, t, emb):
        a = acp[t.long()].reshape(-1, 1, 1, 1)
        return (x9[..., :4] - torch.sqrt(a) * latent) / torch.sqrt(1.0 - a)

    guidance = sds.SDSGuidance(
        eps, lambda img: torch.cat([img, img[..., :1] * 0], -1),
        lambda z: z[..., :3], sds.SDSConfig(guidance_scale=100.0))
    mask = torch.zeros((64, 96), device="cuda")
    mask[16:48, 24:72] = 1.0
    g = torch.Generator(device="cuda").manual_seed(5)
    t = torch.tensor([500], device="cuda")
    noise = torch.randn((1, size, size, 4), generator=g, device="cuda")
    _steps_through_k7_and_plain(
        monkeypatch, lambda: sds_trainer.sds_train_step(
            state, cam, gt, mask, torch.tensor(BG, device="cuda"),
            gs_trainer.INPAINT_OPT, guidance, torch.zeros((2, 1, 8),
                                                          device="cuda"),
            spatial_lr_scale=1.3, sh_degree=3, sds_weight=2e-3,
            sds_size=size, t=t, noise=noise))


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
@pytest.mark.parametrize("mode", ["blended", "inversion"])
def test_cuda_tiny_blended_and_inversion_samples_match_cpu(mode):
    """The tiny SVD engine's ``sample_blended`` / ``sample_inversion`` (2
    steps) on CUDA against the same weights on the CPU, the same noise
    and renoise draws, f32 with TF32 off: the latents within 1e-4 of
    their largest magnitude plus 4 f32 spacings at each entry's magnitude
    entering the first step (|x0| = sqrt(1 + 700^2) |noise|; for the
    inversion the top inverted latent outside the mask)."""
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
        rng = np.random.default_rng(6)
        frame = rng.uniform(-1, 1, (1, 64, 48, 3)).astype(np.float32)
        batch = {"cond_frames_without_noise": frame, "cond_frames": frame,
                 "fps_id": np.array([6.0], np.float32),
                 "motion_bucket_id": np.array([127.0], np.float32),
                 "cond_aug": np.array([0.0], np.float32),
                 "control_hint": rng.uniform(0, 1, (3, 64, 48, 7)).astype(
                     np.float32)}
        lat = (3, 8, 6, 4)
        noise, z = (torch.from_numpy(rng.normal(size=lat).astype(
            np.float32)) for _ in range(2))
        renoise = [torch.from_numpy(rng.normal(size=lat).astype(np.float32))
                   for _ in range(2)]
        mask = torch.zeros(lat)
        mask[:, 2:6, 1:4] = 1.0
        outs, tops = [], []
        for eng, dev in ((cpu, "cpu"), (gpu, "cuda")):
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            c = eng.prepare_cond(b)
            uc = eng.prepare_cond(b, unconditional=True)
            uc["control_hint"] = c["control_hint"]
            args = (c, uc, z.to(dev), mask.to(dev))
            inverted = []
            prev = samplers.set_latent_debug_hook(
                lambda tag, s, x: inverted.append(x)
                if tag == "invert" else 0)
            try:
                if mode == "blended":
                    out = eng.sample_blended(*args, noise=noise,
                                             num_steps=2, renoise=renoise)
                else:
                    out = eng.sample_inversion(*args, noise=noise,
                                               num_steps=2)
            finally:
                samplers.set_latent_debug_hook(prev)
            outs.append(out.cpu())
            tops.append(torch.from_numpy(inverted[-1]) if inverted else None)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    x0 = samplers.prepare_x(noise, torch.tensor([cfg.sigma_max])).abs()
    start = (x0 if mode == "blended"
             else mask * x0 + (1 - mask) * tops[0].abs())
    spacing = torch.ldexp(torch.ones_like(start),
                          torch.frexp(start).exponent - 24)
    assert torch.isfinite(outs[1]).all()
    assert ((outs[1] - outs[0]).abs()
            <= 1e-4 * float(outs[0].abs().max()) + 4 * spacing).all()


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


def _no_tf32():
    """Both TF32 switches off (as chip_smoke.py sets them); returns the
    previous settings."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return saved


def _restore_tf32(saved):
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _moved(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["musiq", "wadiqam", "lpips"])
def test_cuda_quality_metrics_match_cpu(metric):
    """MUSIQ (full width, 1 + 34*60 + 7*12 + 4*7 = 2,153 tokens at 1080p),
    WaDIQaM-NR (1,980 patches at 1080p) and LPIPS (full VGG16 on a
    [2, 256, 256, 3] pair) on CUDA against the same weights on the CPU,
    f32 with TF32 off: within 1e-4 relative; no kernel launches."""
    _require_cuda()
    from multiview_inpaint_tpu_torch import kernels
    from multiview_inpaint_tpu_torch.metrics import lpips, musiq, wadiqam
    saved = _no_tf32()
    try:
        torch.manual_seed(0)
        rng = np.random.default_rng(3)
        kernels.reset_launches()
        if metric == "lpips":
            net = _moved(lpips.LPIPS(), 1)
            a = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
            b = np.clip(a + 0.2 * rng.normal(size=a.shape), -1, 1).astype(
                np.float32)
            outs = []
            for dev in ("cpu", "cuda"):
                with torch.no_grad():
                    outs.append(net.to(dev)(torch.from_numpy(a).to(dev),
                                            torch.from_numpy(b).to(dev))
                                .cpu().numpy())
            want, got = outs
        else:
            img = rng.random((1080, 1920, 3)).astype(np.float32)
            if metric == "musiq":
                net = _moved(musiq.MUSIQ(), 1)
                assert net.tokens(img[None]) == 2153
                flat = musiq.state_dict_to_jax(net.state_dict(),
                                               net.cfg.heads)
                scorers = [musiq.MUSIQScorer(flat, device=d)
                           for d in ("cpu", "cuda")]
            else:
                from multiview_inpaint_tpu_torch.diffusion import checkpoint
                flat = checkpoint.torch_to_flax(_moved(
                    wadiqam.WaDIQaMNR(), 1).state_dict())
                scorers = [wadiqam.WaDIQaMScorer(flat, device=d)
                           for d in ("cpu", "cuda")]
            want, got = (np.array([s(img)]) for s in scorers)
        assert np.all(np.isfinite(got))
        assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want)), (got,
                                                                    want)
        assert sum(kernels.LAUNCHES.values()) == 0
    finally:
        _restore_tf32(saved)


@pytest.mark.cuda
def test_cuda_tiny_vae_finetune_step_matches_cpu():
    """One ``vae_finetune --tiny`` step (generator then discriminator
    update, disc_start 0) on CUDA against the CPU from the same weights,
    batch and posterior noise, f32 with TF32 off: every logged value
    within 1e-5 relative; the generator's gradients (read from Adam's
    first moment, 0.5 g) within 2e-6 + 1e-4 max|g| of their leaf plus
    2e-7 max|g| of the network (the bar of
    ``tests/test_torch_vae_finetune.py``); the parameters after Adam
    within 2e-6 + 1e-4 max|update| of their leaf, or within 2 lr where
    the CPU gradient entry is under that bar (a sign-like first update of
    a gradient that is 0 up to rounding)."""
    _require_cuda()
    from multiview_inpaint_tpu_torch.diffusion.autoencoder_loss import (
        GANLossConfig)
    from multiview_inpaint_tpu_torch.pipelines import vae_finetune as vf
    saved = _no_tf32()
    try:
        lr = 2e-3
        cfg = GANLossConfig(disc_start=0, disc_weight=0.5,
                            perceptual_weight=0.0, learn_logvar=True,
                            regularization_weights=(("kl_loss", 1e-6),))
        torch.manual_seed(0)
        models = {"cpu": vf.build_models(True, "cpu")}
        for m in models["cpu"]:
            _moved(m, 1)
        models["cuda"] = vf.build_models(True, "cuda")
        for a, b in zip(models["cpu"], models["cuda"]):
            b.load_state_dict(a.state_dict())
        rng = np.random.default_rng(2)
        x = np.tanh(rng.normal(size=(2, 32, 32, 3))).astype(np.float32)
        noise = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
        logs, params, grads, start = {}, {}, {}, None
        for dev, (vae, disc) in models.items():
            tuner = vf.Finetuner(vae, disc, cfg, lr)
            if start is None:
                start = {k: p.detach().clone() for k, p in
                         tuner.gen_params.items()}
            logs[dev] = {k: float(v) for k, v in tuner.step(
                torch.from_numpy(x).to(dev), 0,
                torch.from_numpy(noise).to(dev)).items()}
            params[dev] = {k: p.detach().cpu() for k, p in
                           tuner.gen_params.items()}
            grads[dev] = {k: m.cpu() / 0.5 for k, m in
                          tuner.gen_state["mu"].items()}
        for k, w in logs["cpu"].items():
            assert abs(logs["cuda"][k] - w) <= 1e-5 * abs(w), (k, w)
        top = max(float(g.abs().max()) for g in grads["cpu"].values())
        for k, w in params["cpu"].items():
            g = grads["cpu"][k]
            bar = 2e-6 + 2e-7 * top + 1e-4 * float(g.abs().max())
            assert float((grads["cuda"][k] - g).abs().max()) <= bar, k
            upd = (w - start[k]).abs()
            err = (params["cuda"][k] - w).abs()
            beyond = err > 2e-6 + 1e-4 * float(upd.max())
            assert bool(torch.all(g.abs()[beyond] <= bar)) and bool(
                torch.all(err[beyond] <= 2 * lr + 1e-6)), k
    finally:
        _restore_tf32(saved)


def _nccl_world1():
    """The default process group over NCCL at world size 1 (tcp on
    localhost)."""
    import socket

    from multiview_inpaint_tpu_torch.parallel import mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh.init(0, 1, f"tcp://127.0.0.1:{port}", "cuda")


def _tiny_svd_on_card(cfg, seed):
    """The engine of ``cfg`` on the card with every parameter moved."""
    from multiview_inpaint_tpu_torch.diffusion import engine
    cpu = _moved(engine.init_engine(cfg, seed=0, device="cpu"), seed)
    gpu = engine.init_engine(cfg, seed=1, device="cuda")
    gpu.load_reference_state_dict(cpu.reference_state_dict())
    return gpu


@pytest.mark.cuda
def test_cuda_frame_sharded_apply_model_world1_matches_apply_model():
    """``frame_sharded_apply_model`` over NCCL at world size 1 (its
    all-to-alls, all-reduces and all-gather on the card) against
    ``apply_model`` on the tiny SVD engine (svd_test --tiny_model, 4 frames
    at 64x48, f32, TF32 off), the CFG batch of 8 rows: within 1e-5 of
    max|out| (only the temporal GroupNorms' sums run in another order)."""
    _require_cuda()
    import argparse

    import torch.distributed as dist

    from multiview_inpaint_tpu_torch.parallel.svd_inference_parallel import (
        frame_sharded_apply_model)
    from multiview_inpaint_tpu_torch.pipelines import svd_test
    saved = _no_tf32()
    try:
        eng = _tiny_svd_on_card(svd_test._engine_config(argparse.Namespace(
            tiny_model=True, num_frames=4, num_steps=2)), 3)
        rng = np.random.default_rng(4)

        def t(*shape):
            return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                                device="cuda")
        x, tn = t(8, 8, 6, 4), t(8)
        cond = {"concat": t(8, 8, 6, 4), "crossattn": t(8, 1, 16),
                "vector": t(8, 768), "control_hint": t(8, 64, 48, 7)}
        with torch.no_grad():
            want = eng.apply_model(x, tn, cond)
        _nccl_world1()
        try:
            assert dist.get_backend() == "nccl"
            got = frame_sharded_apply_model(eng, x, tn, cond)
        finally:
            dist.destroy_process_group()
    finally:
        _restore_tf32(saved)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
def test_cuda_dp_train_step_world1_matches_train_step():
    """``make_dp_train_step`` over NCCL at world size 1 (the gradients'
    flat all-reduce on the card) against ``make_train_step``: one step of
    2 videos of the tiny SVD engine (svd_train --tiny_model, 3 frames at
    64x48, f32, TF32 off) from the same parameters and draws, EMA 0.9:
    the loss within 1e-6 relative, parameters and EMA within 1e-3 lr where
    |g| >= 1e-6."""
    _require_cuda()
    import argparse

    import torch.distributed as dist

    from multiview_inpaint_tpu_torch.parallel import svd_data_parallel as dp
    from multiview_inpaint_tpu_torch.pipelines import svd_train
    lr = 1e-4
    saved = _no_tf32()
    try:
        eng = _tiny_svd_on_card(svd_train._engine_config(argparse.Namespace(
            tiny_model=True, num_frames=3, pose_cond=False,
            warp_loss=False)), 5)
        rng = np.random.default_rng(6)

        def t(x):
            return torch.tensor(x, dtype=torch.float32, device="cuda")
        cond = {k: t(v) for k, v in {
            "crossattn": rng.normal(size=(2, 3, 1, 16)),
            "vector": rng.normal(size=(2, 3, 768)),
            "concat": rng.normal(size=(2, 3, 8, 6, 4)),
            "control_hint": rng.uniform(size=(2, 3, 64, 48, 7))}.items()}
        lat = t(rng.normal(size=(2, 3, 8, 6, 4)))
        draws = dict(sigmas=t([1.7, 0.4]),
                     noise=t(rng.normal(size=(2, 3, 8, 6, 4))))
        params = dp.trainable_params(eng)
        p0 = {k: p.detach().clone() for k, p in params.items()}
        runs = []
        for make in (dp.make_train_step, dp.make_dp_train_step):
            dp.apply_trainable(params, p0)
            opt = dp.build_optimizer(lr)
            state = opt.init(params)
            ema = {k: p.detach().clone() for k, p in params.items()}
            if make is dp.make_dp_train_step:
                _nccl_world1()
            try:
                loss = make(eng, opt, params, 0.9)(state, ema, lat, cond,
                                                   **draws)
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
            runs.append((float(loss), {k: p.detach().clone()
                                       for k, p in params.items()},
                         ema, state["mu"]))
    finally:
        _restore_tf32(saved)
    (l0, p_ref, e_ref, mu), (l1, p_dp, e_dp, _) = runs
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for k in mu:
        big = mu[k].abs() >= 1e-7
        for got, want in ((p_dp, p_ref), (e_dp, e_ref)):
            err = (got[k] - want[k]).abs()[big]
            assert err.numel() == 0 or float(err.max()) <= 1e-3 * lr, k
