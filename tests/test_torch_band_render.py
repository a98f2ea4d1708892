"""Port parity, band mode of the rasterizer: ``render(band_rows=,
band_row0=, band_stride=)``, the binning's band rects and the plain K2
and K3 with a band's tile-row origin, against the JAX package's band
render (``backend="xla"``) on the CPU.

Bars:
- the port's bands, stitched, are bitwise equal to the port's full frame
  (rgb, depth, alpha), and their pair counts sum exactly to the frame's;
- each port band against the JAX band at ``test_torch_rasterizer.py``'s
  image tolerances (rgb/alpha 3e-5, depth 3e-4), radii exactly, pairs
  exactly;
- the band rects (binning) exactly equal to JAX's on identical projected
  inputs;
- a band's gradients (plain K3 with the band's origin, the gather and the
  projection) at the gradient bar 2e-6 + 1e-4 max|g| against JAX's band
  VJP, and the sum over the bands' gradients against the full frame's at
  the same bar (only the order of the pair sums differs).

D in {1, 2, 3}, interleaved (stride D, row0 = d) and contiguous (stride
1, row0 = d * band_rows) bands, on a 72-row frame (5 tile rows: not a
multiple of D * 16).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_inpaint_tpu.ops import rasterizer as jr
from multiview_inpaint_tpu.ops.rasterizer import binning as jbinning
from multiview_inpaint_tpu_torch.ops import rasterizer as tr
from multiview_inpaint_tpu_torch.ops.rasterizer import binning as tbinning
from multiview_inpaint_tpu_torch.parallel.render_parallel import (
    band_layout, stitch_bands)
from test_torch_rasterizer import (BG, DEPTH_TOL, RGB_TOL, _camera,
                                   _jax_project, _jax_render, _port, _scene,
                                   _t)

W, H, TILE = 48, 72, 16
TILES_Y = -(-H // TILE)


def _bands(d, interleaved):
    rows, stride, row0s = band_layout(TILES_Y, d, interleaved)
    return [dict(band_rows=rows, band_row0=r, band_stride=stride)
            for r in row0s]


@pytest.fixture(scope="module")
def scene():
    jp = _scene(160, seed=21, deg=1, capacity=176, xy=1.2)
    return jp, _port(jp), _camera(width=W, height=H, z=3.5)


@pytest.fixture(scope="module")
def full(scene):
    _, tp, cam = scene
    return tr.render(tp, tr.RenderCamera.from_camera(cam, "cpu"), BG,
                     sh_degree=1, device="cpu")


@pytest.mark.parametrize("interleaved", [True, False])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_band_render_matches_jax_and_stitches_to_full_frame(
        scene, full, d, interleaved):
    jp, tp, cam = scene
    rcam = tr.RenderCamera.from_camera(cam, "cpu")
    outs = []
    for kw in _bands(d, interleaved):
        got = tr.render(tp, rcam, BG, sh_degree=1, device="cpu", **kw)
        want = _jax_render(jp, cam, sh_degree=1, band_rows=kw["band_rows"],
                           band_row0=jnp.int32(kw["band_row0"]),
                           band_stride=kw["band_stride"])
        assert got.rgb.shape == (kw["band_rows"] * TILE, W, 3)
        np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb),
                                   atol=RGB_TOL)
        np.testing.assert_allclose(got.depth.numpy(),
                                   np.asarray(want.depth), atol=DEPTH_TOL)
        np.testing.assert_allclose(got.alpha.numpy(),
                                   np.asarray(want.alpha), atol=RGB_TOL)
        np.testing.assert_array_equal(got.radii.numpy(),
                                      np.asarray(want.radii))
        assert got.pairs == int(want.pairs)
        outs.append(got)
    for f in ("rgb", "depth", "alpha"):
        stitched = stitch_bands(torch.stack([getattr(o, f) for o in outs]),
                                interleaved, TILE, H)
        assert torch.equal(stitched, getattr(full, f)), f
    assert sum(o.pairs for o in outs) == full.pairs
    assert all(torch.equal(o.radii, full.radii) for o in outs)


@pytest.mark.parametrize("row0,stride", [(0, 3), (2, 3), (1, 2), (3, 1)])
def test_band_rects_integer_exact(scene, row0, stride):
    jp, _, cam = scene
    proj = _jax_project(jp, cam, sh_degree=1)
    rows = -(-(TILES_Y - row0) // stride)
    tiles_x = -(-W // TILE)
    kw = dict(tiles_x=tiles_x, tiles_y=rows, tile_w=TILE, tile_h=TILE,
              pair_budget=64 * jp.capacity, max_per_tile=1024,
              extent=proj.extent, tile_row0=jnp.int32(row0),
              tiles_y_total=TILES_Y, tile_row_stride=stride)
    args = (proj.means2d, proj.radius, proj.depth)
    seg = jbinning.bin_gaussians(*args, gather_ids=False, aligned_chunk=128,
                                 **kw)
    dense = jbinning.bin_gaussians(*args, **kw)
    got = tbinning.bin_gaussians(
        _t(proj.means2d), _t(proj.radius), _t(proj.depth), tiles_x, rows,
        TILE, TILE, extent=_t(proj.extent), tile_row0=row0,
        tiles_y_total=TILES_Y, tile_row_stride=stride)
    total = int(seg.total_pairs)
    assert got.total_pairs == total == int(dense.total_pairs) > 0
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(seg.counts))
    np.testing.assert_array_equal(got.seg_start.numpy(),
                                  np.asarray(seg.seg_start))
    np.testing.assert_array_equal(got.gid_sorted.numpy(),
                                  np.asarray(seg.gid_sorted)[:total])
    # each band tile's gaussians, in depth order, as the XLA gather sees
    ids = got.order[got.gid_sorted].numpy()
    d_ids, d_valid = np.asarray(dense.ids), np.asarray(dense.valid)
    for t in range(tiles_x * rows):
        s, c = int(got.seg_start[t]), int(got.counts[t])
        np.testing.assert_array_equal(ids[s:s + c], d_ids[t][d_valid[t]])


def _grads(render_fn, tp, target):
    names = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
             "rotation")
    leaves = {f: getattr(tp, f).detach().clone().requires_grad_(True)
              for f in names}
    offset = torch.zeros((tp.capacity, 2), requires_grad=True)
    params = type(tp)(live=tp.live, **leaves)
    out = render_fn(params, offset)
    loss = ((out.rgb - target) ** 2).sum() + 0.1 * out.depth.sum() \
        + 0.05 * out.alpha.sum()
    loss.backward()
    return {**{f: leaves[f].grad for f in names},
            "means2d_offset": offset.grad}


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=2e-6 + 1e-4 * np.abs(want).max(),
                               err_msg=what)


def test_band_gradients_match_jax_vjp_and_sum_to_full_frame(scene):
    jp, tp, cam = scene
    rcam = tr.RenderCamera.from_camera(cam, "cpu")
    target = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    bands = _bands(2, True)
    # the bands cover tile rows 0..5 of the 5-row frame: pad the target
    # to 6 rows (the past-the-frame rows are rendered too)
    rows_pad = 2 * bands[0]["band_rows"]
    tgt = np.pad(target, ((0, rows_pad * TILE - H), (0, 0), (0, 0)))
    total = None
    for kw in bands:
        rows, r0, s = kw["band_rows"], kw["band_row0"], kw["band_stride"]
        local = np.concatenate([tgt[(r0 + l * s) * TILE:
                                    (r0 + l * s + 1) * TILE]
                                for l in range(rows)])

        def jloss(params, offset):
            out = _jax_render(params, cam, sh_degree=1,
                              means2d_offset=offset, band_rows=rows,
                              band_row0=jnp.int32(r0), band_stride=s)
            return (jnp.sum((out.rgb - local) ** 2)
                    + 0.1 * jnp.sum(out.depth) + 0.05 * jnp.sum(out.alpha))

        g_params, g_off = jax.grad(jloss, argnums=(0, 1), allow_int=True)(
            jp, jnp.zeros((jp.capacity, 2)))
        got = _grads(lambda p, o: tr.render(
            p, rcam, BG, sh_degree=1, means2d_offset=o, device="cpu", **kw),
            tp, torch.from_numpy(local))
        for f, g in got.items():
            want = g_off if f == "means2d_offset" else getattr(g_params, f)
            _close(g, want, f"band {r0}: {f}")
        total = got if total is None else {f: total[f] + g
                                           for f, g in got.items()}
    # the same objective over all six rows, as one contiguous band
    want = _grads(lambda p, o: tr.render(
        p, rcam, BG, sh_degree=1, means2d_offset=o, device="cpu",
        band_rows=rows_pad, band_row0=0), tp, torch.from_numpy(tgt))
    for f in want:
        _close(total[f], want[f].numpy(), f"sum of bands: {f}")
