"""Tile binning: per-gaussian tile rects -> depth-rank compaction -> pair
keys (K1) -> one sort -> per-tile segments.

Port of the rank-compaction path of
``multiview_inpaint_tpu/ops/rasterizer/binning.py``:

1. rects from the per-axis extents with the reference's EXCLUSIVE upper
   bound ``floor(max/tile) + 1`` (``binning.py:219-230``; deliberately not
   CUDA ``getRect``, which drops the tile holding the last covered pixel);
2. a stable sort of the gaussians on ``depth`` keyed ``inf`` where
   count == 0, so the pair-emitting gaussians form a prefix in depth-rank
   order (``binning.py:278-299``);
3. int64 ``starts`` (exclusive cumsum of the counts) and the pair-key
   kernel (K1, ``pair_expand.expand_keys``): key ``tile << 32 | rank``;
4. one ``torch.sort`` of the int64 keys, and ``counts``/``seg_start``
   from the sorted tile ids.

Pairs are allocated exactly (``total_pairs``): there is no pair budget,
no per-tile cap and no key-encoding variant. The JAX ``cull_n`` (a cap on
the compacted actives, TPU capacity knob) has no counterpart either: the
keys are sized from the active count read on the host, never more.

Band mode (``tile_row0``; ``binning.py:235-248``): the rects' global tile
rows are intersected with the band's row set ``{row0 + l * stride}`` in
integer space, so everything after, keys, counts and segments, is
band-local over the band's rows, and each band tile's pair list is the
full frame's list of the same tile, in the same order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ... import telemetry
from .pair_expand import KEY_SHIFT, expand_keys


class Rects(NamedTuple):
    """The compacted rect table K1 consumes (all [N], depth-rank order)."""
    order: torch.Tensor    # [N] int64 rank -> gaussian id
    x0: torch.Tensor       # [N] int32 rect origin (tiles)
    y0: torch.Tensor       # [N] int32
    w: torch.Tensor        # [N] int32 rect width (tiles)
    count: torch.Tensor    # [N] int64 pairs (w*h, 0 if culled)
    starts: torch.Tensor   # [N] int64 first pair slot
    n_active: int          # pair-emitting prefix length
    total: int             # total pairs


class TileBins(NamedTuple):
    order: torch.Tensor       # [N] int64 rank -> gaussian id
    gid_sorted: torch.Tensor  # [P] int64 depth rank of each sorted pair
    seg_start: torch.Tensor   # [T] int64 first pair of each tile
    counts: torch.Tensor      # [T] int64 pairs per tile
    total_pairs: int


def compact_rects(means2d: torch.Tensor, radius: torch.Tensor,
                  depth: torch.Tensor, tiles_x: int, tiles_y: int,
                  tile_w: int, tile_h: int,
                  extent: Optional[torch.Tensor] = None,
                  tile_row0: Optional[int] = None,
                  tiles_y_total: Optional[int] = None,
                  tile_row_stride: int = 1) -> Rects:
    """Steps 1-3 up to K1's inputs. One host sync reads the pair total
    and the active count (the keys are allocated exactly): a
    ``host_read`` span, and the total is added to the ``render.pairs``
    counter.

    With ``tile_row0`` the frame has ``tiles_y_total`` tile rows and the
    rects are cut to the band of ``tiles_y`` rows ``tile_row0 + l *
    tile_row_stride``, in the band's local rows."""
    if extent is not None:
        rx = extent[:, 0].to(torch.float32)
        ry = extent[:, 1].to(torch.float32)
    else:
        rx = ry = radius.to(torch.float32)
    ty_clip = tiles_y if tiles_y_total is None else tiles_y_total
    x0 = torch.clamp(torch.floor((means2d[:, 0] - rx) / tile_w), 0, tiles_x)
    y0 = torch.clamp(torch.floor((means2d[:, 1] - ry) / tile_h), 0, ty_clip)
    x1 = torch.clamp(torch.floor((means2d[:, 0] + rx) / tile_w) + 1,
                     0, tiles_x)
    y1 = torch.clamp(torch.floor((means2d[:, 1] + ry) / tile_h) + 1,
                     0, ty_clip)
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    y1 = y1.to(torch.int32)
    if tile_row0 is not None:
        # Local row l covers global row row0 + l*s, inside [y0, y1) iff
        # l in [ceil((y0 - row0) / s), ceil((y1 - row0) / s)); ceil(a / s)
        # = -((-a) // s) with floor division, for either sign of a.
        s = int(tile_row_stride)
        y0 = torch.clamp(-((int(tile_row0) - y0) // s), 0, tiles_y)
        y1 = torch.clamp(-((int(tile_row0) - y1) // s), 0, tiles_y)
    rect_w = (x1.to(torch.int32) - x0)
    rect_h = (y1 - y0)
    count = torch.where(radius > 0, rect_w * rect_h,
                        torch.zeros_like(rect_w))
    sort_key = torch.where(count > 0, depth.to(torch.float32),
                           torch.full_like(depth, float("inf"),
                                           dtype=torch.float32))
    order = torch.sort(sort_key, stable=True).indices
    count = count[order].to(torch.int64)
    ends = torch.cumsum(count, dim=0)
    total, n_active = 0, 0
    if count.numel():
        with telemetry.host_read():
            total, n_active = torch.stack([ends[-1],
                                           (count > 0).sum()]).tolist()
    telemetry.count("render.pairs", int(total))
    return Rects(order=order, x0=x0[order].contiguous(),
                 y0=y0[order].contiguous(), w=rect_w[order].contiguous(),
                 count=count, starts=ends - count, n_active=int(n_active),
                 total=int(total))


def segments_from_keys(keys_sorted: torch.Tensor, num_tiles: int):
    """(counts [T], seg_start [T]) int64 from the sorted pair keys.
    ``bincount`` reads the keys' range on the host: a host read."""
    tiles = keys_sorted >> KEY_SHIFT
    with telemetry.host_read():
        counts = torch.bincount(tiles, minlength=num_tiles)
    return counts, torch.cumsum(counts, dim=0) - counts


def bin_gaussians(means2d: torch.Tensor, radius: torch.Tensor,
                  depth: torch.Tensor, tiles_x: int, tiles_y: int,
                  tile_w: int, tile_h: int,
                  extent: Optional[torch.Tensor] = None,
                  tile_row0: Optional[int] = None,
                  tiles_y_total: Optional[int] = None,
                  tile_row_stride: int = 1) -> TileBins:
    """Per-tile depth-ordered pair segments for one frame, or for the
    band of ``tiles_y`` rows from ``tile_row0`` (``compact_rects``)."""
    rects = compact_rects(means2d, radius, depth, tiles_x, tiles_y, tile_w,
                          tile_h, extent, tile_row0, tiles_y_total,
                          tile_row_stride)
    keys = expand_keys(rects.starts, rects.x0, rects.y0, rects.w,
                       rects.count, rects.n_active, rects.total, tiles_x)
    keys_sorted = torch.sort(keys).values
    counts, seg_start = segments_from_keys(keys_sorted, tiles_x * tiles_y)
    return TileBins(order=rects.order,
                    gid_sorted=keys_sorted & ((1 << KEY_SHIFT) - 1),
                    seg_start=seg_start, counts=counts,
                    total_pairs=rects.total)
