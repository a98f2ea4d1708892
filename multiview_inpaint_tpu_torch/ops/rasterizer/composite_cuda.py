"""The composite kernel (K2) and its backward (K3), and their wrappers.

K2 is the counterpart of
``multiview_inpaint_tpu/ops/rasterizer/pallas_composite.py`` (``_kernel``
via ``composite_pallas``), K3 of ``pallas_backward.py`` (``_bwd_kernel``
via ``composite_pallas_bwd``). The CUDA sources are ``csrc/composite.cu``
(one block per tile, one thread per pixel, splats staged through shared
memory in 128-splat chunks anchored at the tile's segment start) and
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
"""

from __future__ import annotations

import torch

from ... import kernels as _kernels
from .composite import (NROWS, OUT_ROWS, STATE_ROWS, alpha_gate,
                        composite_segments, composite_segments_bwd,
                        item_ends, max_items)

MAX_TILE_PIXELS = 256  # one thread per pixel; 16x16 and 8x16 tiles


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
    if pix > MAX_TILE_PIXELS or pix % 32:
        raise ValueError(f"composite kernels take tiles of <= "
                         f"{MAX_TILE_PIXELS} pixels in whole warps, got "
                         f"{tile_h}x{tile_w}")
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


def _launch(attrs, seg_start, counts, tiles_x, tiles_y, tile_h, tile_w,
            with_state):
    _check(attrs, seg_start, counts, tiles_x, tiles_y, tile_h, tile_w)
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
                           None if state is None else state.data_ptr(),
                           out.data_ptr(), n_tiles, tiles_x, tile_w, tile_h,
                           _kernels.stream_ptr(attrs.device))
    _kernels.check(rc, "composite")
    _kernels.LAUNCHES["composite"] += 1
    return (out, state) if with_state else out


def _launch_bwd(attrs, seg_start, counts, tiles8, g_tiles8, tiles_x,
                tiles_y, tile_h, tile_w, state):
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
                               _kernels.stream_ptr(attrs.device))
    _kernels.check(rc, "composite_bwd")
    _kernels.LAUNCHES["composite_bwd"] += 1
    return d_attrs


def _device_type(attrs: torch.Tensor) -> str:
    if attrs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"composite: unsupported device {attrs.device}")
    return attrs.device.type


def composite_fwd(attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                  tile_w, with_state: bool = False):
    """K2: raw [T, 8, PIX] tiles, and with ``with_state`` also the
    per-item state [max_items, 5, PIX] that K3 starts from. CPU tensors
    take the plain version, CUDA tensors launch the kernel."""
    if _device_type(attrs) == "cpu":
        return composite_segments(attrs, seg_start, counts, tiles_x,
                                  tiles_y, tile_h, tile_w,
                                  with_state=with_state)
    return _launch(attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                   tile_w, with_state)


def composite_bwd(attrs, seg_start, counts, tiles8, g_tiles8, tiles_x,
                  tiles_y, tile_h, tile_w, state=None) -> torch.Tensor:
    """K3: d attrs [P, 16] from the forward's raw tiles, their cotangent
    and the forward's per-item ``state``. CPU tensors take the plain
    version (which also walks each tile from its start when ``state`` is
    None); CUDA tensors launch the kernel, which needs the state."""
    if _device_type(attrs) == "cpu":
        return composite_segments_bwd(attrs, seg_start, counts, tiles8,
                                      g_tiles8, tiles_x, tiles_y, tile_h,
                                      tile_w, state)
    return _launch_bwd(attrs, seg_start, counts, tiles8, g_tiles8, tiles_x,
                       tiles_y, tile_h, tile_w, state)


class _CompositeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                tile_w):
        # The per-item state only when a backward can follow.
        if ctx.needs_input_grad[0]:
            tiles8, state = composite_fwd(attrs, seg_start, counts, tiles_x,
                                          tiles_y, tile_h, tile_w,
                                          with_state=True)
        else:
            tiles8 = composite_fwd(attrs, seg_start, counts, tiles_x,
                                   tiles_y, tile_h, tile_w)
            state = None
        ctx.save_for_backward(attrs, seg_start, counts, tiles8, state)
        ctx.size = (tiles_x, tiles_y, tile_h, tile_w)
        return tiles8

    @staticmethod
    def backward(ctx, grad):
        attrs, seg_start, counts, tiles8, state = ctx.saved_tensors
        d_attrs = composite_bwd(attrs, seg_start, counts, tiles8,
                                grad.contiguous(), *ctx.size, state)
        return d_attrs, None, None, None, None, None, None


def composite(attrs: torch.Tensor, seg_start: torch.Tensor,
              counts: torch.Tensor, tiles_x: int, tiles_y: int,
              tile_h: int, tile_w: int) -> torch.Tensor:
    """Raw [T, 8, PIX] tiles from pair-sorted attrs [P, 16] and int64
    [T] segments, differentiable in ``attrs`` through K3 (the plain
    versions on CPU tensors, the kernels on CUDA tensors; any other
    device raises)."""
    _device_type(attrs)
    return _CompositeFn.apply(attrs, seg_start, counts, tiles_x, tiles_y,
                              tile_h, tile_w)
