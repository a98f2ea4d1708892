"""The composite kernel (K2): fused front-to-back blending of every tile.

Counterpart of ``multiview_inpaint_tpu/ops/rasterizer/pallas_composite.py``
(``_kernel`` via ``composite_pallas``). The CUDA source is
``csrc/composite.cu``: one block per tile, one thread per pixel, splats
staged through shared memory in 128-splat chunks anchored at the tile's
segment start, all in float32. Its plain version is
``composite.composite_segments``; the wrapper takes it only for CPU
tensors.

On CUDA the kernel sits in a ``torch.autograd.Function`` whose backward
(the reference's ``pallas_backward._bwd_kernel``, K3) comes with the GS
training slice and raises until then.
"""

from __future__ import annotations

import torch

from . import _kernels
from .composite import NROWS, OUT_ROWS, alpha_gate, composite_segments

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


def _launch(attrs, seg_start, counts, tiles_x, tiles_y, tile_h, tile_w):
    n_tiles = tiles_x * tiles_y
    pix = tile_h * tile_w
    if pix > MAX_TILE_PIXELS or pix % 32:
        raise ValueError(f"composite kernel takes tiles of <= "
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
    out = torch.empty((n_tiles, OUT_ROWS, pix), dtype=torch.float32,
                      device=attrs.device)
    lib = _kernels.library()
    rc = lib.mvi_composite(attrs.data_ptr(), seg_start.data_ptr(),
                           counts.data_ptr(), out.data_ptr(), n_tiles,
                           tiles_x, tile_w, tile_h,
                           _kernels.stream_ptr(attrs.device))
    _kernels.check(rc, "composite")
    _kernels.LAUNCHES["composite"] += 1
    return out


class _CompositeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                tile_w):
        return _launch(attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                       tile_w)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the composite backward kernel (K3, pallas_backward._bwd_kernel "
            "in the reference) is ported with the GS training slice; "
            "differentiate on the CPU path until then")


def composite(attrs: torch.Tensor, seg_start: torch.Tensor,
              counts: torch.Tensor, tiles_x: int, tiles_y: int,
              tile_h: int, tile_w: int) -> torch.Tensor:
    """Raw [T, 8, PIX] tiles from pair-sorted attrs [P, 16] and int64
    [T] segments. CPU tensors take the plain version; CUDA tensors launch
    the kernel; any other device raises."""
    if attrs.device.type == "cpu":
        return composite_segments(attrs, seg_start, counts, tiles_x,
                                  tiles_y, tile_h, tile_w)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite: unsupported device {attrs.device}")
    return _CompositeFn.apply(attrs, seg_start, counts, tiles_x, tiles_y,
                              tile_h, tile_w)
