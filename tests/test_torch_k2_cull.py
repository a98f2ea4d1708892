"""K2's per-warp gate culling, held against the gate decisions on the CPU.

The CUDA composite (K2, ``csrc/composite.cu``) lets a warp skip a splat
whose gate box misses the warp's pixel rectangle. That is exact only if
every pixel where the plain walk (``composite._chunk``) keeps the splat
lies inside its box; ``composite.gate_bound`` and ``composite.gate_box``
compute the kernel's bound and box with its float32 roundings (up to the
last place of logf), so these tests hold the cull's premise, and that of
K2's early reject at the bound, where the kernels cannot run: on seeded
random splats and on adversarial ones (near-singular conics, conics that
are not positive definite, opacity at the gate's floor, odd opacities
and gates, means off the tile), on 16x16 and 8x16 tiles. They also
hold the thread-to-pixel map of K2's blocks, whose warp rectangles must
cover every pixel of the tile exactly once.
"""

import re

import numpy as np
import pytest
import torch

from multiview_inpaint_tpu_torch.ops.rasterizer import composite as c
from multiview_inpaint_tpu_torch.ops.rasterizer.composite_cuda import (
    pack_attrs)

TILES = [(16, 16), (8, 16)]        # (h, w)
GRID = (4, 3)                      # tiles_x, tiles_y
SRC = c.__file__.rsplit("/ops/", 1)[0] + "/csrc/"


def _const(name):
    text = open(SRC + "composite.cu").read() \
        + open(SRC + "composite_common.cuh").read()
    m = re.search(rf"constexpr (?:float|int) {name} = ([-0-9.e]+)f?;", text)
    return float(m.group(1))


def test_box_constants_match_the_kernel():
    assert np.float32(_const("kBoundMargin")) == np.float32(c.BOUND_MARGIN)
    assert np.float32(_const("kBoxSlack")) == np.float32(c.BOX_SLACK)
    assert np.float32(_const("kBoxPad")) == np.float32(c.BOX_PAD)
    assert np.float32(_const("kBoxCond")) == np.float32(c.BOX_COND)


def _attrs(mean, conic, opacity, gate=None):
    n = mean.shape[0]
    attrs = pack_attrs(torch.as_tensor(mean, dtype=torch.float32),
                       torch.as_tensor(conic, dtype=torch.float32),
                       torch.as_tensor(opacity, dtype=torch.float32),
                       torch.full((n, 3), 0.5), torch.ones(n))
    if gate is not None:   # a gate other than pack_attrs' alpha_gate
        attrs[:, 10] = torch.as_tensor(gate, dtype=torch.float32)
    return attrs


def _random(n, seed, extent):
    """Rotated ellipses of 0.2-12 px axes over the tile grid and a margin
    around it, opacities over (0, 1]."""
    rng = np.random.default_rng(seed)
    w, h = extent
    mean = np.stack([rng.uniform(-12, w + 12, n),
                     rng.uniform(-12, h + 12, n)], 1)
    s = np.exp(rng.uniform(np.log(0.2), np.log(12.0), (n, 2)))
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    # conic = R diag(1/s^2) R^T
    i1, i2 = 1 / s[:, 0] ** 2, 1 / s[:, 1] ** 2
    conic = np.stack([cs * cs * i1 + sn * sn * i2, cs * sn * (i1 - i2),
                      sn * sn * i1 + cs * cs * i2], 1)
    op = rng.uniform(0.0, 1.0, n) ** 2
    return _attrs(mean, conic, op)


def _adversarial(extent):
    """Splats at the edges of the box's premises."""
    w, h = extent
    rows = []
    rng = np.random.default_rng(7)
    for k in range(400):
        mx, my = rng.uniform(0, w), rng.uniform(0, h)
        a = float(np.exp(rng.uniform(-6, 2)))
        cc = float(np.exp(rng.uniform(-6, 2)))
        # Near-singular: a c / det around BOX_COND (1 - rho^2 = 1 / R).
        r = float(np.exp(rng.uniform(np.log(50), np.log(5e5))))
        b = np.sqrt(a * cc * (1 - 1 / r)) * (1 if k % 2 else -1)
        rows.append((mx, my, a, b, cc, 1.0))
    for mx, my in ((w / 2, h / 2), (-30.0, h / 2), (w + 0.5, -0.5),
                   (3.0, 3.0), (w / 3 + 0.5, h / 4 + 0.5)):
        rows += [
            (mx, my, 0.02, 0.3, 0.02, 1.0),     # det < 0: a hyperbola
            (mx, my, 0.1, 0.1, 0.1, 1.0),       # det = 0
            (mx, my, -0.05, 0.0, -0.05, 1.0),   # negative definite
            (mx, my, 0.0, 0.0, 0.0, 1.0),       # zero conic
            (mx, my, 0.5, 0.0, 0.5, c.ALPHA_MIN),     # opacity at the floor
            (mx, my, 0.5, 0.0, 0.5, c.ALPHA_MIN / c.GATE_E),
            (mx, my, 1e4, 0.0, 1e4, 1.0),       # sub-pixel, on a pixel
            (mx, my, 1e-5, 0.0, 1e-5, 1.0),     # larger than the frame
            (mx, my, 1e30, 0.0, 1e30, 1.0),     # a c overflows
            (mx, my, 3.0, 2.9999, 3.0, 0.99),   # near-singular, huge R
        ]
    # Far off the tile, and non-finite means.
    rows += [(-1e6, 5.0, 0.5, 0.0, 0.5, 1.0), (5.0, 1e30, 0.5, 0.0, 0.5,
                                                 1.0),
             (float("nan"), 5.0, 0.5, 0.0, 0.5, 1.0),
             (float("inf"), 5.0, 0.5, 0.0, 0.5, 1.0)]
    arr = np.array(rows, dtype=np.float64)
    attrs = _attrs(arr[:, :2], arr[:, 2:5], arr[:, 5])
    # Opacities and gates outside what the binning packs: NaN, zero and
    # negative opacities, a zero gate, a gate below opacity * e^-4.5.
    odd = _attrs(np.full((5, 2), (w / 2 + 0.5, h / 2)),
                 np.tile([0.3, 0.05, 0.2], (5, 1)),
                 [float("nan"), 0.0, -0.5, 0.7, 0.7],
                 gate=[0.01, 0.01, 0.01, 0.0, 1e-4])
    return torch.cat([attrs, odd])


def _kept_and_power(attrs, tile):
    """keep [T, PIX, P] from the plain walk's chunks (every tile's
    segment is all of ``attrs``), the float32 power there, and the
    pixel coordinates [T, PIX, 2]."""
    th, tw = tile
    tiles_x, tiles_y = GRID
    n_tiles, n = tiles_x * tiles_y, attrs.shape[0]
    coords = c.tile_pixel_coords(tiles_x, tiles_y, tw, th)
    seg_start = torch.zeros(n_tiles, dtype=torch.int64)
    counts = torch.full((n_tiles,), n, dtype=torch.int64)
    t_carry = torch.ones((n_tiles, th * tw))
    lane = torch.arange(c.CHUNK)
    zero = torch.zeros(())
    tl = torch.arange(n_tiles)
    keep, power = [], []
    for c0 in range(0, n, c.CHUNK):
        s = c._chunk(attrs, seg_start, counts, coords, t_carry, tl, c0,
                     lane, zero)
        ok = s.ok[0]
        keep.append(s.keep[:, :, ok])
        a = s.a[:, None, ok]
        power.append(-0.5 * (a[..., 2] * s.dx[..., ok] * s.dx[..., ok]
                             + a[..., 4] * s.dy[..., ok] * s.dy[..., ok])
                     - a[..., 3] * s.dx[..., ok] * s.dy[..., ok])
    return torch.cat(keep, -1), torch.cat(power, -1), coords


def _inside(box, coords):
    """[T, PIX, P] whether each pixel lies inside each splat's box."""
    x = coords[:, :, None, 0]
    y = coords[:, :, None, 1]
    return ((box[None, None, :, 0] <= x) & (x <= box[None, None, :, 1])
            & (box[None, None, :, 2] <= y) & (y <= box[None, None, :, 3]))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_kept_pixels_lie_inside_the_gate_box(kind, tile):
    th, tw = tile
    extent = (GRID[0] * tw, GRID[1] * th)
    attrs = (_random(1536, 3, extent) if kind == "random"
             else _adversarial(extent))
    keep, power, coords = _kept_and_power(attrs, tile)
    inside = _inside(c.gate_box(attrs), coords)
    bound = c.gate_bound(attrs)[None, None, :]
    assert int(keep.sum()) > 1000
    # Every kept pixel reaches its splat's bound (K2's early reject skips
    # no kept pixel), and every pixel that reaches it lies in the box.
    assert not bool((keep & ~(power >= bound)).any())
    assert not bool(((power >= bound) & ~inside).any())
    assert not bool((keep & ~inside).any())
    if kind == "random":
        # The box is tight: pulled in by one pixel it misses kept pixels
        # (what chip_smoke.py's planted K2 fault relies on).
        assert bool((keep & ~_inside(c.gate_box(attrs, 1.0), coords))
                    .any())


def test_gate_box_gives_the_plane_where_it_cannot_bound():
    attrs = _adversarial((64, 48))
    box = c.gate_box(attrs)
    plane = torch.isinf(box).all(dim=1)
    a, b, cc = (attrs[:, i] for i in (2, 3, 4))
    det = a.double() * cc.double() - b.double() ** 2
    # Not positive definite, a NaN opacity or a zero gate: the plane.
    assert bool(plane[(det <= 0) | (a <= 0)].all())
    bound = c.gate_bound(attrs)
    assert bool(plane[torch.isneginf(bound)].all())
    assert torch.isneginf(bound[-5:-3:2]).all()       # NaN op, zero gate
    assert torch.isposinf(bound[-4:-2]).all()         # op <= 0: none pass
    # The gates pack_attrs packs put the bound at ln(e^-4.5) or above.
    packed = bound[:-5]
    assert bool((packed[torch.isfinite(packed)] >= -4.5 - 2e-4).all())


@pytest.mark.parametrize("tile", TILES)
def test_warp_rectangles_cover_each_pixel_once(tile):
    th, tw = tile
    pix = c.warp_pixels(th, tw)
    assert sorted(pix.tolist()) == list(range(th * tw))
    rw, rh = c.WARP_RECT
    for w in range(th * tw // 32):
        p = pix[32 * w:32 * w + 32]
        x, y = p % tw, p // tw
        # The warp's 32 pixels fill its bounding rectangle exactly.
        assert (int(x.max() - x.min()) + 1, int(y.max() - y.min()) + 1) \
            == (rw, rh)
