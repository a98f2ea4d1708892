"""The projection kernel (K6): the gradient-free projection of one camera.

The port's own kernel, with no Pallas counterpart: the JAX package
projects in jnp that XLA fuses (``multiview_inpaint_tpu/ops/rasterizer/
geometry.py``). Its plain version, ``project_ref``, is the projection as
the render has always computed it: ``GaussianParams``' activations, then
``geometry.project_gaussians``. The CUDA source is ``csrc/project.cu``:
the activations, the view and clip transforms, the EWA covariance, the
culls and the SH colours of every row in one launch, read straight from
the raw parameters (no concatenation of the SH stack, no copy of the
scale bound to the card), rounded operation by operation as the plain
path rounds, so that radius, extent and visibility are the plain path's
exactly.

``project`` takes the plain version on CPU tensors (counted
``project.plain``, as ``api.project`` counts its grad path) and launches
K6 on CUDA tensors (counted ``launch.project``); any other device
raises. It computes no gradient: ``api.project`` calls it only where
none is needed.
"""

from __future__ import annotations

import torch

from ... import kernels as _kernels
from ... import telemetry
from ...gs.gaussians import FIELDS, GaussianParams
from .geometry import ProjectedGaussians, project_gaussians


def project_ref(params: GaussianParams, camera, sh_degree: int,
                scaling_modifier: float = 1.0,
                means2d_offset=None) -> ProjectedGaussians:
    """Plain version of K6: activate the params and project them for
    ``camera`` (a ``RenderCamera``) with the plain ops."""
    return project_gaussians(
        params.xyz, params.features(), params.act_opacity()[:, 0],
        params.act_scaling(), params.act_rotation(), params.live,
        camera.world_view, camera.full_proj, camera.campos,
        camera.tan_fovx, camera.tan_fovy, camera.width, camera.height,
        sh_degree, scaling_modifier, means2d_offset)


def _check(params: GaussianParams, camera, sh_degree: int) -> None:
    dev = params.xyz.device
    n = params.capacity
    if not 0 <= sh_degree <= min(3, params.max_sh_degree):
        raise ValueError(f"project: SH degree {sh_degree} outside [0, "
                         f"{min(3, params.max_sh_degree)}]")
    m = params.features_rest.shape[1]
    shapes = {"xyz": (n, 3), "features_dc": (n, 1, 3),
              "features_rest": (n, m, 3), "opacity": (n, 1),
              "scaling": (n, 3), "rotation": (n, 4), "live": (n,)}
    for f in FIELDS:
        t = getattr(params, f)
        dt = torch.bool if f == "live" else torch.float32
        if t.dtype != dt or tuple(t.shape) != shapes[f] or t.device != dev:
            raise ValueError(f"project: {f} must be {dt} {shapes[f]} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for name, shape in (("world_view", (4, 4)), ("full_proj", (4, 4)),
                        ("campos", (3,))):
        t = getattr(camera, name)
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != dev):
            raise ValueError(f"project: camera {name} must be float32 "
                             f"{shape} on {dev}")


def project(params: GaussianParams, camera, sh_degree: int,
            scaling_modifier: float = 1.0) -> ProjectedGaussians:
    """``ProjectedGaussians`` of every row for ``camera``, without a
    gradient. CPU tensors take the plain version; CUDA tensors launch K6
    on the current stream, which nothing waits for."""
    dev = params.xyz.device
    if dev.type == "cpu":
        telemetry.count("project.plain")
        return project_ref(params, camera, sh_degree, scaling_modifier)
    if dev.type != "cuda":
        raise ValueError(f"project: unsupported device {dev}")
    _check(params, camera, sh_degree)
    n = params.capacity
    f32 = torch.float32
    means2d = torch.empty((n, 2), dtype=f32, device=dev)
    conic = torch.empty((n, 3), dtype=f32, device=dev)
    depth = torch.empty((n,), dtype=f32, device=dev)
    radius = torch.empty((n,), dtype=torch.int32, device=dev)
    color = torch.empty((n, 3), dtype=f32, device=dev)
    opacity = torch.empty((n,), dtype=f32, device=dev)
    extent = torch.empty((n, 2), dtype=f32, device=dev)
    ins = [getattr(params, f).contiguous() for f in FIELDS]
    cam = [camera.world_view.contiguous(), camera.full_proj.contiguous(),
           camera.campos.contiguous()]
    w, h = camera.width, camera.height
    rc = _kernels.library().mvi_project(
        *(t.data_ptr() for t in ins + cam), n,
        params.features_rest.shape[1] * 3, sh_degree, float(w), float(h),
        w / (2.0 * camera.tan_fovx), h / (2.0 * camera.tan_fovy),
        1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy,
        float(scaling_modifier),
        *(t.data_ptr() for t in (means2d, conic, depth, radius, color,
                                 opacity, extent)),
        _kernels.stream_ptr(dev))
    _kernels.check(rc, "project")
    telemetry.count("launch.project")
    return ProjectedGaussians(means2d=means2d, conic=conic, depth=depth,
                              radius=radius, color=color, opacity=opacity,
                              extent=extent)
