"""Front-to-back alpha compositing: constants, the plain versions of the
composite kernel (K2) and its backward (K3), and the untiled oracle.

Port of ``multiview_inpaint_tpu/ops/rasterizer/composite.py``. Per tile
and per 128-splat chunk of the tile's own pair segment (chunks anchored at
the segment start, as in the JAX XLA path):

    alpha[P, C]  = min(0.99, opacity * exp(-0.5 d^T conic d))   (gated)
    T_in[P, C]   = carry_T * exp(exclusive_cumsum(log1p(-alpha)))
    w[P, C]      = alpha * T_in * [T_out >= 1e-4]
    acc         += w @ [rgb, depth]
    carry_T     *= exp(sum of the contributing logs)

The stop rule is chunk-scoped, exactly as the reference's: within a chunk
the first splat that would push T below 1e-4 is skipped and so is every
later splat of that chunk (their prefix includes its log), but the carry
sums only contributing logs, so a low-alpha splat of the NEXT chunk can
contribute again. (CUDA 3DGS stops the pixel for good instead.)

Work items: a tile's segment is cut into items of ``ITEM_CHUNKS`` chunks
(``ITEM_PAIRS`` pairs), numbered over the frame in tile order
(``item_ends``). The forward can return its state at the start of every
item (``STATE_ROWS`` per pixel: the carried T and the rgb and depth
accumulators), and the backward can start each item from that state
instead of walking the tile from its start, which lets the CUDA backward
(K3) give each item a block of its own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DEPTH_EMPTY = 15.0  # far-background depth sentinel (reference contract)
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_STOP = 1e-4
# Per-splat alpha cutoff = the opacity-aware k-sigma ellipse the binning
# extents encode (k = min(3, sqrt(2 ln(255 op))), geometry.py): alpha >=
# max(1/255, op*e^{-4.5}). Gating per pixel on the exact ellipse makes the
# composited image independent of the tile shape.
GATE_E = 0.011108996538242306  # e^{-4.5}
CHUNK = 128  # splats per compositing step (the reference's chunk)
# Packed per-pair attribute rows (``composite_cuda.pack_attrs``):
# 0 mean_x, 1 mean_y, 2-4 conic abc, 5 opacity, 6-8 rgb, 9 depth,
# 10 alpha gate, 11-15 zero pad. Raw output rows per tile: 0-2 bg-free
# rgb accumulators, 3 depth accumulator, 4 final T, 5-7 zero.
NROWS = 16
OUT_ROWS = 8
# Chunks per work item, the CUDA kernels' kItemChunks
# (csrc/composite_common.cuh), and the pairs an item spans.
ITEM_CHUNKS = 8
ITEM_PAIRS = ITEM_CHUNKS * CHUNK
# Per-item state rows: 0 the carried T at the item's start, 1-3 the rgb
# accumulators and 4 the depth accumulator there.
STATE_ROWS = 5
# Tile-batch size of the plain version: bounds its [tiles, PIX, CHUNK]
# intermediates to ~2^25 elements whatever the frame size.
_PLAIN_ELEMS = 1 << 25


def alpha_gate(opacity: torch.Tensor) -> torch.Tensor:
    """Per-splat minimum contributing alpha (see GATE_E). K3 rejects a
    splat early where its power is below ``kPowerGated``
    (csrc/composite_common.cuh), which is sound only while this gate is
    at least opacity * e^-4.5; tests/test_torch_k3_items.py holds the
    two together."""
    return torch.clamp(opacity * GATE_E, min=ALPHA_MIN)


# K2's gate culling (csrc/composite.cu). A splat's gate bound is the
# least power at which it can pass its gate: ln(gate / opacity) less
# BOUND_MARGIN (the roundings of expf, the product and logf). Its gate
# box bounds the ellipse where the power reaches the bound, Q = a dx^2 +
# 2 b dx dy + c dy^2 <= q with q = -2 bound * BOX_SLACK: half-extents
# sqrt(q c / det) and sqrt(q a / det) (det = a c - b^2) plus BOX_PAD
# pixels. Conics that are not positive definite, too near singular (a c
# / det above BOX_COND) or not finite get the whole plane.
BOUND_MARGIN = 1e-4
BOX_SLACK = 1.01
BOX_PAD = 0.0625
BOX_COND = 1000.0
# K2's warp rectangles: 8x4 pixels where the tile is made of them.
WARP_RECT = (8, 4)


def gate_bound(attrs: torch.Tensor) -> torch.Tensor:
    """Plain version of K2's gate bound: [P] float32, the least power at
    which each packed splat (row 5 opacity, row 10 gate) can pass its
    gate; +inf where none can, -inf where the gate is not positive or the
    opacity is NaN (the kernels' fminf clamps a NaN alpha to 0.99). Equal
    to the kernel's up to the last place of logf."""
    op, g = attrs[:, 5], attrs[:, 10]
    bound = torch.log(g / op) - BOUND_MARGIN
    bound = torch.where(op > 0, bound, float("inf"))
    return torch.where((g > 0) & ~torch.isnan(op), bound, -float("inf"))


def gate_box(attrs: torch.Tensor, shrink: float = 0.0) -> torch.Tensor:
    """Plain version of K2's gate box: [P, 4] float32 (x0, x1, y0, y1) of
    every packed splat, the kernel's formula and roundings in float32 (up
    to the last place of ``gate_bound``'s logf). A warp skips a splat
    whose box misses its pixel rectangle; every pixel where the splat's
    power reaches its gate bound, and so every pixel that keeps it, lies
    inside the box. ``shrink`` pulls every side in by that many pixels
    (a planted fault)."""
    mx, my, a, b, c = attrs[:, :5].unbind(1)
    bound = gate_bound(attrs)
    q = torch.where(bound < 0, (-2.0 * BOX_SLACK) * bound, 0.0)
    ac = a * c
    det = ac - b * b
    whole = ~((a > 0) & (det > 0) & (ac < float("inf"))
              & (ac <= BOX_COND * det) & (q < float("inf")))
    hx = torch.sqrt(q * c / det) + BOX_PAD - shrink
    hy = torch.sqrt(q * a / det) + BOX_PAD - shrink
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], dim=1)
    plane = torch.tensor([-1.0, 1.0, -1.0, 1.0], device=attrs.device) \
        * float("inf")
    return torch.where(whole[:, None], plane, box)


def warp_pixels(tile_h: int, tile_w: int) -> torch.Tensor:
    """[PIX] int64: the tile-local pixel (row-major index) of each thread
    of K2's block. A warp takes a WARP_RECT rectangle where the tile is
    made of them (16x16 and 8x16 tiles), else 32 consecutive pixels."""
    t = torch.arange(tile_h * tile_w)
    rw, rh = WARP_RECT
    if tile_w % rw or tile_h % rh:
        return t
    warp, lane = t // 32, t % 32
    per_row = tile_w // rw
    lx = (warp % per_row) * rw + lane % rw
    ly = (warp // per_row) * rh + lane // rw
    return ly * tile_w + lx


def item_ends(counts: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the tiles of their items (a segment of c
    pairs is ceil(c / ITEM_PAIRS) items): tile t's items are numbered
    [ends[t] - items_t, ends[t])."""
    return torch.cumsum(torch.div(counts + (ITEM_PAIRS - 1), ITEM_PAIRS,
                                  rounding_mode="floor"), 0)


def max_items(n_tiles: int, n_pairs: int) -> int:
    """An upper bound on the items of any frame of ``n_tiles`` tiles and
    ``n_pairs`` pairs, known without reading the counts: sum_t ceil(c_t /
    M) <= sum_t (c_t // M + 1) <= n_pairs // M + n_tiles."""
    return n_tiles + n_pairs // ITEM_PAIRS


def _item_of(ends, counts, tl, c0):
    """The item number of chunk ``c0`` (a multiple of ITEM_PAIRS) of the
    tiles ``tl``."""
    first = ends[tl] - torch.div(counts[tl] + (ITEM_PAIRS - 1), ITEM_PAIRS,
                                 rounding_mode="floor")
    return first + c0 // ITEM_PAIRS


def tile_pixel_coords(tiles_x: int, tiles_y: int, tile_w: int, tile_h: int,
                      device=None, row0: int = 0,
                      stride: int = 1) -> torch.Tensor:
    """[T, PIX, 2] integer-valued float32 pixel coordinates of every tile
    (the reference's ``_tile_pixel_coords``: no +0.5 offset). In band
    mode local tile row ty is the frame's row ``row0 + ty * stride``
    (the JAX ``render``'s origin shift, ``api.py:333``)."""
    ty, tx = torch.meshgrid(torch.arange(tiles_y), torch.arange(tiles_x),
                            indexing="ij")
    origin = torch.stack([tx.reshape(-1) * tile_w,
                          (row0 + ty.reshape(-1) * stride) * tile_h],
                         dim=-1)
    ly, lx = torch.meshgrid(torch.arange(tile_h), torch.arange(tile_w),
                            indexing="ij")
    local = torch.stack([lx.reshape(-1), ly.reshape(-1)], dim=-1)
    return (origin[:, None, :] + local[None, :, :]).to(
        dtype=torch.float32, device=device)


class _Chunk(NamedTuple):
    """One chunk of a batch of tiles, recomputed as the forward does;
    every per-splat tensor is [L, PIX, C]."""
    idx: torch.Tensor        # [L, C] pair index (0 where not ok)
    ok: torch.Tensor         # [L, C] lane inside the tile's segment
    a: torch.Tensor          # [L, C, 16] packed attributes
    dx: torch.Tensor
    dy: torch.Tensor
    ex: torch.Tensor         # exp(power)
    alpha_raw: torch.Tensor  # opacity * exp(power), unclamped
    alpha: torch.Tensor      # clamped and gated
    keep: torch.Tensor       # passes the gate
    logs: torch.Tensor       # log1p(-alpha)
    t_in: torch.Tensor
    contrib: torch.Tensor    # T_out >= T_STOP
    w: torch.Tensor          # blend weight


def _chunk(attrs, seg_start, counts, coords, t_carry, tl, c0, lane,
           zero) -> _Chunk:
    """The forward of tiles ``tl`` over splats [c0, c0 + C) of their
    segments. The plain K2 and plain K3 both call it, so the backward
    takes exactly the forward's gate and stop decisions."""
    k = c0 + lane
    ok = k[None, :] < counts[tl, None]                      # [L, C]
    idx = torch.where(ok, seg_start[tl, None] + k[None, :], 0)
    a = attrs[idx]                                          # [L, C, 16]
    pxy = coords[tl]                                        # [L, P, 2]
    dx = pxy[:, :, None, 0] - a[:, None, :, 0]              # [L, P, C]
    dy = pxy[:, :, None, 1] - a[:, None, :, 1]
    ca = a[:, None, :, 2]
    cb = a[:, None, :, 3]
    cc = a[:, None, :, 4]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    ex = torch.exp(power)
    alpha_raw = a[:, None, :, 5] * ex
    alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
    keep = (alpha >= a[:, None, :, 10]) & ok[:, None, :] & (power <= 0)
    alpha = torch.where(keep, alpha, zero)
    logs = torch.log1p(-alpha)
    cum = torch.cumsum(logs, dim=-1)
    tc = t_carry[tl][:, :, None]
    t_out = tc * torch.exp(cum)
    t_in = tc * torch.exp(cum - logs)
    contrib = t_out >= T_STOP
    w = torch.where(contrib, alpha * t_in, zero)
    return _Chunk(idx, ok, a, dx, dy, ex, alpha_raw, alpha, keep, logs,
                  t_in, contrib, w)


def _chunks(counts, pix, chunk):
    """(c0, tiles) of every chunk step: only tiles whose segment reaches
    the chunk do work, in batches that bound the [L, PIX, C]
    intermediates."""
    n_tiles = counts.shape[0]
    k_max = int(counts.max()) if n_tiles else 0
    batch = max(1, _PLAIN_ELEMS // (pix * chunk))
    for c0 in range(0, k_max, chunk):
        busy = torch.nonzero(counts > c0).flatten()
        for lo in range(0, busy.numel(), batch):
            yield c0, busy[lo:lo + batch]


def composite_segments(attrs: torch.Tensor, seg_start: torch.Tensor,
                       counts: torch.Tensor, tiles_x: int, tiles_y: int,
                       tile_h: int, tile_w: int, chunk: int = CHUNK,
                       with_state: bool = False, row0: int = 0,
                       stride: int = 1):
    """Plain version of the composite kernel (K2).

    attrs [P, 16] pair-sorted packed attributes; seg_start/counts [T]
    int64 segment of each tile. Returns raw [T, 8, PIX] tiles (see
    OUT_ROWS); the caller composites the background. Differentiable
    through autograd (every update is out of place). With ``with_state``
    it also returns the per-item state [max_items(T, P), STATE_ROWS, PIX]
    (not differentiated; rows past the frame's items are 0): the carry T
    and the accumulators at the start of every item, recorded from this
    walk's own carry. In band mode the T tiles are ``tiles_y`` band rows,
    local row ty at the frame's tile row ``row0 + ty * stride``.
    """
    dev = attrs.device
    n_tiles = tiles_x * tiles_y
    pix = tile_h * tile_w
    coords = tile_pixel_coords(tiles_x, tiles_y, tile_w, tile_h, dev, row0,
                               stride)
    t_carry = torch.ones((n_tiles, pix), dtype=torch.float32, device=dev)
    acc = torch.zeros((n_tiles, pix, 4), dtype=torch.float32, device=dev)
    lane = torch.arange(chunk, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if with_state:
        ends = item_ends(counts)
        state = torch.zeros((max_items(n_tiles, attrs.shape[0]),
                             STATE_ROWS, pix), dtype=torch.float32,
                            device=dev)
    for c0, tl in _chunks(counts, pix, chunk):
        if with_state and c0 % ITEM_PAIRS == 0:
            item = _item_of(ends, counts, tl, c0)
            state[item, 0] = t_carry[tl].detach()
            state[item, 1:] = acc[tl].detach().transpose(1, 2)
        s = _chunk(attrs, seg_start, counts, coords, t_carry, tl, c0, lane,
                   zero)
        acc = acc.index_put((tl,), acc[tl] + s.w @ s.a[:, :, 6:10])
        t_carry = t_carry.index_put((tl,), t_carry[tl] * torch.exp(
            torch.sum(torch.where(s.contrib, s.logs, zero), dim=-1)))
    pad = torch.zeros((n_tiles, OUT_ROWS - 5, pix), dtype=torch.float32,
                      device=dev)
    tiles8 = torch.cat([acc.transpose(1, 2), t_carry[:, None, :], pad],
                       dim=1)
    return (tiles8, state) if with_state else tiles8


def composite_segments_bwd(attrs: torch.Tensor, seg_start: torch.Tensor,
                           counts: torch.Tensor, tiles8: torch.Tensor,
                           g_tiles8: torch.Tensor, tiles_x: int,
                           tiles_y: int, tile_h: int, tile_w: int,
                           state: torch.Tensor | None = None,
                           row0: int = 0, stride: int = 1
                           ) -> torch.Tensor:
    """Plain version of the composite backward kernel (K3).

    From the forward's raw tiles ``tiles8`` and their cotangent
    ``g_tiles8`` (both [T, 8, PIX]; rows 0-3 the rgb and depth
    accumulators, row 4 the final T), returns d attrs [P, 16] with the
    identity of the reference's ``pallas_backward.py:8-16``, per pixel:

        A_i = g_rgb . c_i + g_d d_i
        S_i = TotalContrib - Prefix_i        (TotalContrib = g . acc)
        dL/dalpha_i = T_i A_i - (S_i + T_fin g_T) / (1 - alpha_i)

    for every contributing splat, then through alpha = min(0.99, op
    exp(power)) to the means, conic and opacity; d rgb / d depth are
    sum_p w g. The walk is the forward's (``_chunk``), so the gate and
    stop decisions are the forward's. Rows: 0-1 d mean, 2-4 d conic,
    5 d opacity, 6-8 d rgb, 9 d depth; rows 10 (the alpha gate: a
    comparison carries no gradient) and 11-15 are 0.

    With the forward's per-item ``state`` (``composite_segments(...,
    with_state=True)``) every item starts from it: T from its row 0 and
    the prefix of w.A from g . its accumulators, as the CUDA K3 does.
    Without it the walk carries both from the tile's start. ``row0`` and
    ``stride`` place a band's tiles as in ``composite_segments``.
    """
    dev = attrs.device
    n_tiles = tiles_x * tiles_y
    pix = tile_h * tile_w
    coords = tile_pixel_coords(tiles_x, tiles_y, tile_w, tile_h, dev, row0,
                               stride)
    t_carry = torch.ones((n_tiles, pix), dtype=torch.float32, device=dev)
    prefix = torch.zeros((n_tiles, pix), dtype=torch.float32, device=dev)
    g4 = g_tiles8[:, 0:4, :].transpose(1, 2)                # [T, PIX, 4]
    total = torch.sum(g4 * tiles8[:, 0:4, :].transpose(1, 2), dim=-1)
    b_term = tiles8[:, 4, :] * g_tiles8[:, 4, :]            # T_fin g_T
    d_attrs = torch.zeros((attrs.shape[0], NROWS), dtype=torch.float32,
                          device=dev)
    lane = torch.arange(CHUNK, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ends = item_ends(counts) if state is not None else None
    for c0, tl in _chunks(counts, pix, CHUNK):
        g = g4[tl]                                           # [L, P, 4]
        if state is not None and c0 % ITEM_PAIRS == 0:
            st = state[_item_of(ends, counts, tl, c0)]       # [L, 5, P]
            t_carry[tl] = st[:, 0]
            prefix[tl] = torch.sum(g * st[:, 1:].transpose(1, 2), dim=-1)
        s = _chunk(attrs, seg_start, counts, coords, t_carry, tl, c0, lane,
                   zero)
        big_a = g @ s.a[:, :, 6:10].transpose(1, 2)          # [L, P, C]
        wa = s.w * big_a
        suffix = (total[tl] - prefix[tl])[:, :, None] - torch.cumsum(wa, -1)
        d_alpha = torch.where(
            s.contrib & s.keep,
            s.t_in * big_a - (suffix + b_term[tl][:, :, None])
            / (1.0 - s.alpha), zero)
        d_raw = torch.where(s.alpha_raw < ALPHA_MAX, d_alpha, zero)
        d_power = d_raw * s.alpha_raw
        ca = s.a[:, None, :, 2]
        cb = s.a[:, None, :, 3]
        cc = s.a[:, None, :, 4]
        rows = torch.stack([
            torch.sum(d_power * (ca * s.dx + cb * s.dy), dim=1),
            torch.sum(d_power * (cc * s.dy + cb * s.dx), dim=1),
            torch.sum(-0.5 * d_power * s.dx * s.dx, dim=1),
            torch.sum(-d_power * s.dx * s.dy, dim=1),
            torch.sum(-0.5 * d_power * s.dy * s.dy, dim=1),
            torch.sum(d_raw * s.ex, dim=1),
        ], dim=-1)                                           # [L, C, 6]
        rows = torch.cat([rows, s.w.transpose(1, 2) @ g], dim=-1)
        d_attrs[s.idx[s.ok], :10] = rows[s.ok]
        prefix[tl] = prefix[tl] + torch.sum(wa, dim=-1)
        t_carry[tl] = t_carry[tl] * torch.exp(
            torch.sum(torch.where(s.contrib, s.logs, zero), dim=-1))
    return d_attrs


def composite_dense(means2d, conic, color, depth, opacity, order,
                    width: int, height: int, bg_color, radius=None,
                    tile: tuple[int, int] | None = (16, 16), extent=None):
    """Reference oracle: every pixel against every gaussian, no tiling.

    ``order`` is the depth argsort of the gaussians (culled ones sort last
    with opacity 0). With ``radius``/``tile`` a splat only reaches pixels
    whose tile intersects its rect (``extent``: the per-axis AABB the
    tiled path bins with). O(H*W*N): tests only.
    """
    dev = means2d.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).to(
        torch.float32)
    mu = means2d[order]
    co = conic[order]
    col = color[order]
    dep = depth[order]
    op = opacity[order]
    dx = pix[:, None, 0] - mu[None, :, 0]
    dy = pix[:, None, 1] - mu[None, :, 1]
    power = (-0.5 * (co[None, :, 0] * dx * dx + co[None, :, 2] * dy * dy)
             - co[None, :, 1] * dx * dy)
    alpha = torch.clamp(op[None, :] * torch.exp(power), max=ALPHA_MAX)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    alpha = torch.where((alpha >= alpha_gate(op)[None, :]) & (power <= 0),
                        alpha, zero)
    if radius is not None and tile is not None:
        th, tw = tile
        if extent is not None:
            rx = extent[order, 0].to(torch.float32)
            ry = extent[order, 1].to(torch.float32)
        else:
            rx = ry = radius[order].to(torch.float32)
        px_tile = torch.floor(pix[:, 0] / tw)
        py_tile = torch.floor(pix[:, 1] / th)
        x0 = torch.floor((mu[:, 0] - rx) / tw)
        x1 = torch.floor((mu[:, 0] + rx) / tw) + 1
        y0 = torch.floor((mu[:, 1] - ry) / th)
        y1 = torch.floor((mu[:, 1] + ry) / th) + 1
        in_rect = ((px_tile[:, None] >= x0[None]) &
                   (px_tile[:, None] < x1[None]) &
                   (py_tile[:, None] >= y0[None]) &
                   (py_tile[:, None] < y1[None]))
        alpha = torch.where(in_rect, alpha, zero)
    logs = torch.log1p(-alpha)
    cum = torch.cumsum(logs, dim=-1)
    t_out = torch.exp(cum)
    t_in = torch.exp(cum - logs)
    contrib = t_out >= T_STOP
    w = torch.where(contrib, alpha * t_in, zero)
    t_fin = torch.exp(torch.sum(torch.where(contrib, logs, zero), dim=-1))
    rgb = w @ col + t_fin[:, None] * bg_color[None, :]
    dpt = w @ dep + t_fin * DEPTH_EMPTY
    return (rgb.reshape(height, width, 3), dpt.reshape(height, width),
            (1.0 - t_fin).reshape(height, width))
