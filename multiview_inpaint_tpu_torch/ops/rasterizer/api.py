"""Public rasterizer API: ``render``, ``render_views``, ``render_oracle``.

Port of ``multiview_inpaint_tpu/ops/rasterizer/api.py`` (the reference's
``GaussianRasterizer(...) -> (image, radii, depth)`` plus its render-dict
wrapper): project -> bin (K1 + sort) -> gather the packed attributes in
pair order -> composite (K2) -> background and depth sentinel.

``render`` runs on ``device`` (default ``cuda``); params and camera are
moved there (a no-op when they already live there). On ``cpu`` every
kernel wrapper takes its plain version, on ``cuda`` it launches its
kernel. The render is differentiable on both devices: the composite's
backward is K3 (its plain version on ``cpu``), the gather of the packed
attributes reduces the pair gradients to gaussians, and autograd carries
them through the projection (``means2d_offset`` included). On ``cuda``
the projection is one launch of K6 (``project_cuda``) and its backward
one launch of K7; on ``cpu`` both run their plain versions. A camera's
gradient, which K7 does not write, is taken on ``cpu`` alone, through
the plain ops.

Band mode (``band_rows``) renders only the tile rows ``band_row0 + l *
band_stride`` of the frame, l = 0..band_rows-1, for single-frame
sharding (``parallel.render_parallel.render_frame_sharded``,
``parallel.gs_band_train``): the projection stays full-frame, the binning
cuts the rects to the band's rows in integer tile space, and K2 and K3
place each local tile row at its frame row. Each band tile's pair list
and its order are the full frame's, so the band's pixels are bit-equal
to the same rows of the full frame.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ... import telemetry
from ...gs.gaussians import GaussianParams
from ...utils.device import DEFAULT_DEVICE, resolve_device
from . import binning, composite, project_cuda
from .composite_cuda import composite as composite_tiles
from .composite_cuda import pack_attrs


@dataclasses.dataclass(frozen=True)
class RenderCamera:
    """Camera constants for one view."""
    world_view: torch.Tensor  # [4,4]
    full_proj: torch.Tensor   # [4,4]
    campos: torch.Tensor      # [3]
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int

    @classmethod
    def from_camera(cls, cam, device=DEFAULT_DEVICE) -> "RenderCamera":
        """From a ``gs.cameras.Camera``."""
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev)

        return cls(world_view=t(cam.world_view), full_proj=t(cam.full_proj),
                   campos=t(cam.camera_center),
                   tan_fovx=cam.tan_half_fovx, tan_fovy=cam.tan_half_fovy,
                   width=cam.width, height=cam.height)

    def to(self, device) -> "RenderCamera":
        return dataclasses.replace(
            self, world_view=self.world_view.to(device),
            full_proj=self.full_proj.to(device),
            campos=self.campos.to(device))


class RenderOutput(NamedTuple):
    rgb: torch.Tensor         # [H, W, 3]
    depth: torch.Tensor       # [H, W]
    alpha: torch.Tensor       # [H, W]
    radii: torch.Tensor       # [N] int32
    visibility: torch.Tensor  # [N] bool (radii > 0)
    pairs: int = 0            # gaussian-tile pairs of this frame


def assemble(tiles: torch.Tensor, tiles_x: int, tiles_y: int, tile_w: int,
             tile_h: int, width: int, height: int) -> torch.Tensor:
    """[T, PIX, C?] tile blocks -> [H, W, C?] image (padding cropped)."""
    ch = tuple(tiles.shape[2:])
    img = tiles.reshape((tiles_y, tiles_x, tile_h, tile_w) + ch)
    img = torch.movedim(img, 2, 1)  # [ty, th, tx, tw, ...]
    img = img.reshape((tiles_y * tile_h, tiles_x * tile_w) + ch)
    return img[:height, :width]


def camera_grad(camera: RenderCamera) -> bool:
    """Whether autograd is on and a camera tensor requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in (
        camera.world_view, camera.full_proj, camera.campos))


def project(params: GaussianParams, camera: RenderCamera, sh_degree: int,
            scaling_modifier: float = 1.0,
            means2d_offset: Optional[torch.Tensor] = None):
    """Activate the params and project them for ``camera``.

    ``project_cuda.project_grad``: K6 forward (counted ``launch.project``)
    and, where the params or ``means2d_offset`` need a gradient, K7
    backward (counted ``launch.project_bwd``) on CUDA tensors; their plain
    versions on CPU tensors (counted ``project.plain``). K7 writes no
    gradient for the camera: where a camera tensor requires one, CPU
    tensors take the plain ops, differentiable (counted
    ``project.plain``), and any other device raises."""
    if camera_grad(camera):
        if params.xyz.device.type != "cpu":
            raise ValueError(
                "project: a camera tensor requires a gradient, which K7 "
                f"does not write; on {params.xyz.device} detach the "
                "camera, or project on the CPU")
        telemetry.count("project.plain")
        return project_cuda.project_ref(params, camera, sh_degree,
                                        scaling_modifier, means2d_offset)
    return project_cuda.project_grad(params, camera, sh_degree,
                                     scaling_modifier, means2d_offset)


def render(params: GaussianParams, camera: RenderCamera,
           bg_color, sh_degree: int = 0, scaling_modifier: float = 1.0,
           means2d_offset: Optional[torch.Tensor] = None,
           tile: tuple[int, int] = (16, 16),
           band_rows: Optional[int] = None,
           band_row0: Optional[int] = None,
           band_stride: int = 1,
           device=DEFAULT_DEVICE) -> RenderOutput:
    """Render one view on ``device``. ``tile`` is (h, w): 16x16 or 8x16
    on CUDA (one thread per pixel, <= 256 pixels), any shape on CPU.

    With ``band_rows`` only the band of tile rows ``band_row0 + l *
    band_stride`` (``band_row0`` a Python int, default 0) is rendered:
    rgb, depth and alpha hold its ``band_rows * tile_h`` rows in local
    order (the caller stitches the bands and crops to the frame), and
    ``pairs`` counts the band's pairs; radii and visibility come from the
    full projection.

    Spans (``telemetry``): ``render`` around it all, inside it
    ``render.project``, ``render.bin`` (rects, K1, the key sort,
    segments), ``render.gather`` (the packed attributes in pair order)
    and ``render.composite`` (K2, background, assembly)."""
    with telemetry.span("render"):
        dev = resolve_device(device)
        params = params.to(dev)
        camera = camera.to(dev)
        bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
        if means2d_offset is not None:
            means2d_offset = means2d_offset.to(dev)
        tile_h, tile_w = tile
        tiles_x = -(-camera.width // tile_w)
        tiles_y_total = -(-camera.height // tile_h)
        if band_rows is None:
            tiles_y, row0, stride = tiles_y_total, None, 1
            out_h = camera.height
        else:
            tiles_y, stride = int(band_rows), int(band_stride)
            row0 = 0 if band_row0 is None else int(band_row0)
            out_h = tiles_y * tile_h

        with telemetry.span("render.project"):
            proj = project(params, camera, sh_degree, scaling_modifier,
                           means2d_offset)
        with telemetry.span("render.bin"):
            bins = binning.bin_gaussians(
                proj.means2d.detach(), proj.radius, proj.depth.detach(),
                tiles_x, tiles_y, tile_w, tile_h, extent=proj.extent,
                tile_row0=row0, tiles_y_total=tiles_y_total,
                tile_row_stride=stride)
        with telemetry.span("render.gather"):
            packed = pack_attrs(proj.means2d, proj.conic, proj.opacity,
                                proj.color, proj.depth)
            attrs = packed[bins.order[bins.gid_sorted]]        # [P, 16]
        with telemetry.span("render.composite"):
            tiles8 = composite_tiles(attrs, bins.seg_start, bins.counts,
                                     tiles_x, tiles_y, tile_h, tile_w,
                                     row0=row0 or 0,
                                     stride=stride)            # [T, 8, PIX]
            t_fin = tiles8[:, 4, :]
            tile_rgb = torch.stack([tiles8[:, c, :] + t_fin * bg[c]
                                    for c in range(3)], dim=-1)
            tile_depth = tiles8[:, 3, :] + t_fin * composite.DEPTH_EMPTY
            tile_alpha = 1.0 - t_fin
            size = (tiles_x, tiles_y, tile_w, tile_h, camera.width, out_h)
            return RenderOutput(rgb=assemble(tile_rgb, *size),
                                depth=assemble(tile_depth, *size),
                                alpha=assemble(tile_alpha, *size),
                                radii=proj.radius,
                                visibility=proj.radius > 0,
                                pairs=bins.total_pairs)


def render_views(params: GaussianParams, cameras, bg_color,
                 **kwargs) -> RenderOutput:
    """Render several same-size views of one scene; returns RenderOutput
    with a leading view dim (``pairs`` becomes a list)."""
    outs = [render(params, c if isinstance(c, RenderCamera)
                   else RenderCamera.from_camera(
                       c, kwargs.get("device", DEFAULT_DEVICE)),
                   bg_color, **kwargs) for c in cameras]
    if len({tuple(o.rgb.shape) for o in outs}) > 1:
        raise ValueError("render_views needs same-size views; loop render() "
                         "for mixed sizes")
    return RenderOutput(*[torch.stack([getattr(o, f) for o in outs])
                          for f in ("rgb", "depth", "alpha", "radii",
                                    "visibility")],
                        pairs=[o.pairs for o in outs])


def render_oracle(params: GaussianParams, camera: RenderCamera, bg_color,
                  sh_degree: int = 0, scaling_modifier: float = 1.0,
                  device=DEFAULT_DEVICE) -> RenderOutput:
    """Untiled O(H*W*N) golden-path renderer for tests."""
    dev = resolve_device(device)
    params = params.to(dev)
    camera = camera.to(dev)
    proj = project(params, camera, sh_degree, scaling_modifier)
    sort_depth = torch.where(proj.radius > 0, proj.depth,
                             torch.full_like(proj.depth, float("inf")))
    order = torch.sort(sort_depth, stable=True).indices
    rgb, depth, alpha = composite.composite_dense(
        proj.means2d, proj.conic, proj.color, proj.depth, proj.opacity,
        order, camera.width, camera.height,
        torch.as_tensor(bg_color, dtype=torch.float32, device=dev),
        radius=proj.radius, extent=proj.extent)
    return RenderOutput(rgb=rgb, depth=depth, alpha=alpha,
                        radii=proj.radius, visibility=proj.radius > 0)
