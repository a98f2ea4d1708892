"""The composite kernel (K2) and its backward (K3), and their wrappers.

K2 is the counterpart of
``multiview_inpaint_tpu/ops/rasterizer/pallas_composite.py`` (``_kernel``
via ``composite_pallas``), K3 of ``pallas_backward.py`` (``_bwd_kernel``
via ``composite_pallas_bwd``). The CUDA sources are ``csrc/composite.cu``
(one block per tile, one thread per pixel, a warp per 8x4 rectangle;
splats double-buffered through shared memory in 128-splat chunks
anchored at the tile's segment start, each warp walking only the splats
whose gate box meets its rectangle: ``composite.gate_box``) and
``csrc/composite_bwd.cu`` (one block per work item: ``ITEM_CHUNKS``
chunks of one tile's segment), all in float32, with the per-splat
decisions shared through ``csrc/composite_common.cuh``. Their plain
versions are ``composite.composite_segments`` and
``composite.composite_segments_bwd``.

When a backward will follow, K2 also returns the per-item state (the T
and accumulators at the start of every item) and K3 starts each item from
it; the items are numbered on the device (``composite.item_ends``) and
K3's grid is the bound ``composite.max_items``, so neither needs the
counts on the host.

``composite`` is a ``torch.autograd.Function`` on both devices: on CPU
tensors its forward is the plain K2 and its backward the plain K3; on
CUDA tensors it launches K2 and K3. Any other device raises; nothing falls
back to another device or to autograd through the plain forward.

Band mode: every function takes ``row0`` and ``stride`` (0 and 1 for a
full frame), which place local tile row l at the frame's tile row ``row0
+ l * stride`` (the JAX ``render(band_rows=, band_row0=, band_stride=)``).
Both kernels and both plain versions take them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import kernels as _kernels
from ... import telemetry
from .composite import (CHUNK, NROWS, OUT_ROWS, STATE_ROWS, alpha_gate,
                        composite_segments, composite_segments_bwd,
                        item_ends, max_items)

# One thread per pixel (16x16 and 8x16 tiles); K2 computes each chunk's
# gate boxes one splat per thread, so a block has at least CHUNK threads.
MIN_TILE_PIXELS, MAX_TILE_PIXELS = CHUNK, 256


def pack_attrs(means2d, conic, opacity, color, depth) -> torch.Tensor:
    """Dense per-gaussian attrs -> packed [N, 16] (row layout in
    ``composite.NROWS``)."""
    n = means2d.shape[0]
    return torch.cat([
        means2d,                       # 0,1
        conic,                         # 2,3,4
        opacity[:, None],              # 5
        color,                         # 6,7,8
        depth[:, None],                # 9
        alpha_gate(opacity)[:, None],  # 10 (ellipse cutoff)
        torch.zeros((n, NROWS - 11), dtype=torch.float32,
                    device=means2d.device),
    ], dim=1)


def _check(attrs, seg_start, counts, tiles_x, tiles_y, tile_h, tile_w,
           tiles=()):
    n_tiles = tiles_x * tiles_y
    pix = tile_h * tile_w
    if not MIN_TILE_PIXELS <= pix <= MAX_TILE_PIXELS or pix % 32:
        raise ValueError(f"composite kernels take tiles of "
                         f"{MIN_TILE_PIXELS}-{MAX_TILE_PIXELS} pixels in "
                         f"whole warps, got {tile_h}x{tile_w}")
    if attrs.dtype != torch.float32 or attrs.dim() != 2 \
            or attrs.shape[1] != NROWS or not attrs.is_contiguous():
        raise ValueError(f"attrs must be contiguous float32 [P, {NROWS}], "
                         f"got {attrs.dtype} {tuple(attrs.shape)}")
    for name, t in (("seg_start", seg_start), ("counts", counts)):
        if t.dtype != torch.int64 or t.shape != (n_tiles,) \
                or not t.is_contiguous() or t.device != attrs.device:
            raise ValueError(f"{name} must be contiguous int64 [{n_tiles}] "
                             f"on {attrs.device}")
    for name, t, rows, n in tiles:
        if t.dtype != torch.float32 or t.shape != (n, rows, pix) \
                or not t.is_contiguous() or t.device != attrs.device:
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[{n}, {rows}, {pix}] on {attrs.device}")


# K2 launches the deepest tiles first (one device sort of the counts)
# where its grid is at most DEPTH_ORDER_WAVES waves of resident blocks:
# there a deep tile that starts late finishes last. On larger grids the
# sort costs more than it saves, and tiles go in their own order
# (measured in PERF.md).
DEPTH_ORDER_WAVES = 4


@functools.cache
def resident_blocks(device: torch.device, threads: int) -> int:
    """K2's blocks of ``threads`` threads resident on the whole card."""
    per_sm = (ctypes.c_int * 1)()
    _kernels.check(_kernels.library().mvi_composite_residency(
        threads, per_sm), "composite residency")
    return per_sm[0] * torch.cuda.get_device_properties(
        device).multi_processor_count


def _band(row0, stride):
    row0, stride = int(row0), int(stride)
    if row0 < 0 or stride < 1:
        raise ValueError(f"composite: band row0 {row0} must be >= 0 and "
                         f"stride {stride} >= 1")
    return row0, stride


def _launch(attrs, seg_start, counts, tiles_x, tiles_y, tile_h, tile_w,
            with_state, box_shrink=0.0, by_depth=None, row0=0, stride=1):
    """K2 on CUDA tensors. ``by_depth`` forces (True) or forbids (False)
    the deepest-first launch order, which None leaves to the grid's
    waves; ``box_shrink`` pulls every gate box in by that many pixels
    (a planted fault, 0 otherwise); ``row0``/``stride`` place a band."""
    row0, stride = _band(row0, stride)
    _check(attrs, seg_start, counts, tiles_x, tiles_y, tile_h, tile_w)
    if attrs.data_ptr() % 16:
        raise ValueError("composite: attrs must be 16-byte aligned (K2 "
                         "stages its rows by 16-byte asynchronous copies)")
    if by_depth is None:
        by_depth = tiles_x * tiles_y <= DEPTH_ORDER_WAVES * resident_blocks(
            attrs.device, tile_h * tile_w)
    order = (torch.sort(counts, descending=True).indices if by_depth
             else None)
    n_tiles = tiles_x * tiles_y
    pix = tile_h * tile_w
    out = torch.empty((n_tiles, OUT_ROWS, pix), dtype=torch.float32,
                      device=attrs.device)
    ends = state = None
    if with_state:
        ends = item_ends(counts)
        state = torch.empty((max_items(n_tiles, attrs.shape[0]),
                             STATE_ROWS, pix), dtype=torch.float32,
                            device=attrs.device)
    lib = _kernels.library()
    rc = lib.mvi_composite(attrs.data_ptr(), seg_start.data_ptr(),
                           counts.data_ptr(),
                           None if ends is None else ends.data_ptr(),
                           None if order is None else order.data_ptr(),
                           None if state is None else state.data_ptr(),
                           out.data_ptr(), n_tiles, tiles_x, tile_w, tile_h,
                           row0, stride, float(box_shrink),
                           _kernels.stream_ptr(attrs.device))
    _kernels.check(rc, "composite")
    telemetry.count("launch.composite")
    return (out, state) if with_state else out


def _launch_bwd(attrs, seg_start, counts, tiles8, g_tiles8, tiles_x,
                tiles_y, tile_h, tile_w, state, row0=0, stride=1):
    row0, stride = _band(row0, stride)
    n_tiles = tiles_x * tiles_y
    n_items = max_items(n_tiles, attrs.shape[0])
    if state is None:
        raise ValueError("the CUDA composite backward starts every work "
                         "item from the forward's per-item state: pass "
                         "composite_fwd(..., with_state=True)'s state")
    _check(attrs, seg_start, counts, tiles_x, tiles_y, tile_h, tile_w,
           (("tiles8", tiles8, OUT_ROWS, n_tiles),
            ("g_tiles8", g_tiles8, OUT_ROWS, n_tiles),
            ("state", state, STATE_ROWS, n_items)))
    ends = item_ends(counts)
    d_attrs = torch.empty_like(attrs)
    lib = _kernels.library()
    rc = lib.mvi_composite_bwd(attrs.data_ptr(), seg_start.data_ptr(),
                               counts.data_ptr(), ends.data_ptr(),
                               state.data_ptr(), tiles8.data_ptr(),
                               g_tiles8.data_ptr(), d_attrs.data_ptr(),
                               n_tiles, n_items, tiles_x, tile_w, tile_h,
                               row0, stride,
                               _kernels.stream_ptr(attrs.device))
    _kernels.check(rc, "composite_bwd")
    telemetry.count("launch.composite_bwd")
    return d_attrs


def _device_type(attrs: torch.Tensor) -> str:
    if attrs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"composite: unsupported device {attrs.device}")
    return attrs.device.type


def composite_fwd(attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                  tile_w, with_state: bool = False, row0: int = 0,
                  stride: int = 1):
    """K2: raw [T, 8, PIX] tiles, and with ``with_state`` also the
    per-item state [max_items, 5, PIX] that K3 starts from. CPU tensors
    take the plain version, CUDA tensors launch the kernel."""
    if _device_type(attrs) == "cpu":
        row0, stride = _band(row0, stride)
        return composite_segments(attrs, seg_start, counts, tiles_x,
                                  tiles_y, tile_h, tile_w,
                                  with_state=with_state, row0=row0,
                                  stride=stride)
    return _launch(attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                   tile_w, with_state, row0=row0, stride=stride)


def composite_bwd(attrs, seg_start, counts, tiles8, g_tiles8, tiles_x,
                  tiles_y, tile_h, tile_w, state=None, row0: int = 0,
                  stride: int = 1) -> torch.Tensor:
    """K3: d attrs [P, 16] from the forward's raw tiles, their cotangent
    and the forward's per-item ``state``. CPU tensors take the plain
    version (which also walks each tile from its start when ``state`` is
    None); CUDA tensors launch the kernel, which needs the state."""
    if _device_type(attrs) == "cpu":
        return composite_segments_bwd(attrs, seg_start, counts, tiles8,
                                      g_tiles8, tiles_x, tiles_y, tile_h,
                                      tile_w, state, *_band(row0, stride))
    return _launch_bwd(attrs, seg_start, counts, tiles8, g_tiles8, tiles_x,
                       tiles_y, tile_h, tile_w, state, row0, stride)


class _CompositeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                tile_w, row0, stride):
        # The per-item state only when a backward can follow.
        if ctx.needs_input_grad[0]:
            tiles8, state = composite_fwd(attrs, seg_start, counts, tiles_x,
                                          tiles_y, tile_h, tile_w,
                                          with_state=True, row0=row0,
                                          stride=stride)
        else:
            tiles8 = composite_fwd(attrs, seg_start, counts, tiles_x,
                                   tiles_y, tile_h, tile_w, row0=row0,
                                   stride=stride)
            state = None
        ctx.save_for_backward(attrs, seg_start, counts, tiles8, state)
        ctx.size = (tiles_x, tiles_y, tile_h, tile_w)
        ctx.band = (row0, stride)
        return tiles8

    @staticmethod
    def backward(ctx, grad):
        attrs, seg_start, counts, tiles8, state = ctx.saved_tensors
        d_attrs = composite_bwd(attrs, seg_start, counts, tiles8,
                                grad.contiguous(), *ctx.size, state,
                                *ctx.band)
        return d_attrs, None, None, None, None, None, None, None, None


def composite(attrs: torch.Tensor, seg_start: torch.Tensor,
              counts: torch.Tensor, tiles_x: int, tiles_y: int,
              tile_h: int, tile_w: int, row0: int = 0,
              stride: int = 1) -> torch.Tensor:
    """Raw [T, 8, PIX] tiles from pair-sorted attrs [P, 16] and int64
    [T] segments, differentiable in ``attrs`` through K3 (the plain
    versions on CPU tensors, the kernels on CUDA tensors; any other
    device raises). ``row0``/``stride`` place a band's tile rows."""
    _device_type(attrs)
    return _CompositeFn.apply(attrs, seg_start, counts, tiles_x, tiles_y,
                              tile_h, tile_w, row0, stride)
