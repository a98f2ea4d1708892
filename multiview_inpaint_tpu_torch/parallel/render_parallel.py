"""Rendering over ranks: orbit views or one frame's tile-row bands.

Port of ``multiview_inpaint_tpu/parallel/render_parallel.py``. Both paths
replicate the parameters on every rank and end in one ``all_gather``:

- ``render_views_sharded``: the views pad to a multiple of the world size
  by repeating the last camera; rank r renders its slice of them, one
  ``render`` each, and the gathered views are cropped to the request.
- ``render_frame_sharded``: rank r renders the band of tile rows ``r, r +
  D, r + 2D, ...`` (interleaved, the default) or the r-th contiguous band
  (``render(band_rows=, band_row0=, band_stride=)``); the gathered bands
  are stitched back into the frame, and the pair counts summed. Each
  band's pixels are bit-equal to the same rows of the full frame.

Without a process group (or at world size 1) both run on one device and
equal ``render_views`` and ``render``. The JAX compile caches have no
counterpart.
"""

from __future__ import annotations

import torch

from ..ops.rasterizer import RenderCamera, RenderOutput, render
from ..utils.device import DEFAULT_DEVICE
from . import mesh


def band_layout(tiles_y: int, n_bands: int, interleaved: bool = True):
    """(band_rows, stride, row0s) of ``n_bands`` bands over a frame of
    ``tiles_y`` tile rows: interleaved band d holds rows d, d + D, ...;
    contiguous band d rows d * band_rows onward. The last bands may run
    past the frame (those rows are empty and cropped by ``stitch_bands``)."""
    band_rows = -(-tiles_y // n_bands)
    if interleaved:
        return band_rows, n_bands, list(range(n_bands))
    return band_rows, 1, [d * band_rows for d in range(n_bands)]


def stitch_bands(bands: torch.Tensor, interleaved: bool, tile_h: int,
                 height: int) -> torch.Tensor:
    """[D, band_rows * tile_h, ...] bands in rank order -> the [height,
    ...] frame (``render_parallel.py:187-195``): interleaved bands
    re-interleave their tile rows (global row l * D + d), contiguous ones
    concatenate."""
    d, rows_px = bands.shape[:2]
    tail = tuple(bands.shape[2:])
    if interleaved:
        bands = bands.reshape((d, rows_px // tile_h, tile_h) + tail)
        bands = bands.transpose(0, 1)          # [band_rows, D, tile_h, ..]
    return bands.reshape((d * rows_px,) + tail)[:height]


def _camera_statics(c: RenderCamera):
    return (c.width, c.height, c.tan_fovx, c.tan_fovy)


def render_views_sharded(params, cameras, bg_color, device=DEFAULT_DEVICE,
                         **kwargs) -> RenderOutput:
    """Render ``len(cameras)`` views of one scene, the views sharded over
    the ranks; returns what ``rasterizer.render_views`` returns (leading
    view dim, ``pairs`` a list) on every rank. ``render`` kwargs pass
    through; camera statics (size, FOV) must be uniform."""
    protos = [c if isinstance(c, RenderCamera)
              else RenderCamera.from_camera(c, device) for c in cameras]
    if len({_camera_statics(c) for c in protos}) > 1:
        raise ValueError("render_views_sharded needs uniform camera "
                         "statics (width, height, tan_fovx, tan_fovy)")
    n_views = len(protos)
    n_dev, r = mesh.world(), mesh.rank()
    padded = protos + [protos[-1]] * ((-n_views) % n_dev)
    local = len(padded) // n_dev
    outs = [render(params, c, bg_color, device=device, **kwargs)
            for c in padded[r * local:(r + 1) * local]]

    def gather(f):
        return mesh.all_gather_rows(
            torch.stack([getattr(o, f) for o in outs]))[:n_views]

    radii = gather("radii")
    pairs = mesh.all_gather_rows(torch.tensor(
        [o.pairs for o in outs], dtype=torch.int64,
        device=radii.device))[:n_views]
    return RenderOutput(rgb=gather("rgb"), depth=gather("depth"),
                        alpha=gather("alpha"), radii=radii,
                        visibility=radii > 0, pairs=pairs.tolist())


def render_frame_sharded(params, camera, bg_color, interleaved: bool = True,
                         device=DEFAULT_DEVICE, **kwargs) -> RenderOutput:
    """Render ONE view with its tile rows sharded over the ranks; returns
    what ``render`` returns on every rank: the stitched frame, radii and
    visibility of this rank's (replicated) projection, and ``pairs`` the
    summed band counts (every gaussian-tile pair lies in one band, so the
    sum is the frame's). The JAX ``cull_n`` has no counterpart: the
    port's binning is exact to the active count."""
    cam = (camera if isinstance(camera, RenderCamera)
           else RenderCamera.from_camera(camera, device))
    tile_h = kwargs.get("tile", (16, 16))[0]
    n_dev = mesh.world()
    band_rows, stride, row0s = band_layout(-(-cam.height // tile_h), n_dev,
                                           interleaved)
    out = render(params, cam, bg_color, band_rows=band_rows,
                 band_row0=row0s[mesh.rank()], band_stride=stride,
                 device=device, **kwargs)

    def stitch(x):
        bands = mesh.all_gather_rows(x[None])
        return stitch_bands(bands, interleaved, tile_h, cam.height)

    pairs = mesh.all_reduce_sum(torch.tensor(
        [out.pairs], dtype=torch.int64, device=out.radii.device))
    return RenderOutput(rgb=stitch(out.rgb), depth=stitch(out.depth),
                        alpha=stitch(out.alpha), radii=out.radii,
                        visibility=out.visibility, pairs=int(pairs.item()))


def views_sharded(params, views, bg_color, device=DEFAULT_DEVICE, **kwargs):
    """Yield (index, ``RenderOutput``) for every view of ``views``, on
    every rank, rendered in groups of world-size views by
    ``render_views_sharded`` (the CLIs' ``--shard_views``: one group at a
    time on the device, as the JAX ``render_set`` groups its views)."""
    d = mesh.world()
    for lo in range(0, len(views), d):
        group = views[lo:lo + d]
        out = render_views_sharded(params, group, bg_color, device=device,
                                   **kwargs)
        for j in range(len(group)):
            yield lo + j, RenderOutput(
                rgb=out.rgb[j], depth=out.depth[j], alpha=out.alpha[j],
                radii=out.radii[j], visibility=out.visibility[j],
                pairs=out.pairs[j])
