"""The composite kernel (K2) and its backward (K3), and their wrappers.

K2 is the counterpart of
``multiview_inpaint_tpu/ops/rasterizer/pallas_composite.py`` (``_kernel``
via ``composite_pallas``), K3 of ``pallas_backward.py`` (``_bwd_kernel``
via ``composite_pallas_bwd``). The CUDA sources are ``csrc/composite.cu``
and ``csrc/composite_bwd.cu``: one block per tile, one thread per pixel,
splats staged through shared memory in 128-splat chunks anchored at the
tile's segment start, all in float32, with the per-splat decisions shared
through ``csrc/composite_common.cuh``. Their plain versions are
``composite.composite_segments`` and ``composite.composite_segments_bwd``.

``composite`` is a ``torch.autograd.Function`` on both devices: on CPU
tensors its forward is the plain K2 and its backward the plain K3; on
CUDA tensors it launches K2 and K3. Any other device raises; nothing falls
back to another device or to autograd through the plain forward.
"""

from __future__ import annotations

import torch

from ... import kernels as _kernels
from .composite import (NROWS, OUT_ROWS, alpha_gate, composite_segments,
                        composite_segments_bwd)

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
    for name, t in tiles:
        if t.dtype != torch.float32 or t.shape != (n_tiles, OUT_ROWS, pix) \
                or not t.is_contiguous() or t.device != attrs.device:
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[{n_tiles}, {OUT_ROWS}, {pix}] on "
                             f"{attrs.device}")


def _launch(attrs, seg_start, counts, tiles_x, tiles_y, tile_h, tile_w):
    _check(attrs, seg_start, counts, tiles_x, tiles_y, tile_h, tile_w)
    n_tiles = tiles_x * tiles_y
    out = torch.empty((n_tiles, OUT_ROWS, tile_h * tile_w),
                      dtype=torch.float32, device=attrs.device)
    lib = _kernels.library()
    rc = lib.mvi_composite(attrs.data_ptr(), seg_start.data_ptr(),
                           counts.data_ptr(), out.data_ptr(), n_tiles,
                           tiles_x, tile_w, tile_h,
                           _kernels.stream_ptr(attrs.device))
    _kernels.check(rc, "composite")
    _kernels.LAUNCHES["composite"] += 1
    return out


def _launch_bwd(attrs, seg_start, counts, tiles8, g_tiles8, tiles_x,
                tiles_y, tile_h, tile_w):
    _check(attrs, seg_start, counts, tiles_x, tiles_y, tile_h, tile_w,
           (("tiles8", tiles8), ("g_tiles8", g_tiles8)))
    d_attrs = torch.empty_like(attrs)
    lib = _kernels.library()
    rc = lib.mvi_composite_bwd(attrs.data_ptr(), seg_start.data_ptr(),
                               counts.data_ptr(), tiles8.data_ptr(),
                               g_tiles8.data_ptr(), d_attrs.data_ptr(),
                               tiles_x * tiles_y, tiles_x, tile_w, tile_h,
                               _kernels.stream_ptr(attrs.device))
    _kernels.check(rc, "composite_bwd")
    _kernels.LAUNCHES["composite_bwd"] += 1
    return d_attrs


def _device_type(attrs: torch.Tensor) -> str:
    if attrs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"composite: unsupported device {attrs.device}")
    return attrs.device.type


def composite_fwd(attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                  tile_w) -> torch.Tensor:
    """K2: raw [T, 8, PIX] tiles. CPU tensors take the plain version, CUDA
    tensors launch the kernel."""
    if _device_type(attrs) == "cpu":
        return composite_segments(attrs, seg_start, counts, tiles_x,
                                  tiles_y, tile_h, tile_w)
    return _launch(attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                   tile_w)


def composite_bwd(attrs, seg_start, counts, tiles8, g_tiles8, tiles_x,
                  tiles_y, tile_h, tile_w) -> torch.Tensor:
    """K3: d attrs [P, 16] from the forward's raw tiles and their
    cotangent. CPU tensors take the plain version, CUDA tensors launch
    the kernel."""
    if _device_type(attrs) == "cpu":
        return composite_segments_bwd(attrs, seg_start, counts, tiles8,
                                      g_tiles8, tiles_x, tiles_y, tile_h,
                                      tile_w)
    return _launch_bwd(attrs, seg_start, counts, tiles8, g_tiles8, tiles_x,
                       tiles_y, tile_h, tile_w)


class _CompositeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                tile_w):
        tiles8 = composite_fwd(attrs, seg_start, counts, tiles_x, tiles_y,
                               tile_h, tile_w)
        ctx.save_for_backward(attrs, seg_start, counts, tiles8)
        ctx.size = (tiles_x, tiles_y, tile_h, tile_w)
        return tiles8

    @staticmethod
    def backward(ctx, grad):
        attrs, seg_start, counts, tiles8 = ctx.saved_tensors
        d_attrs = composite_bwd(attrs, seg_start, counts, tiles8,
                                grad.contiguous(), *ctx.size)
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
