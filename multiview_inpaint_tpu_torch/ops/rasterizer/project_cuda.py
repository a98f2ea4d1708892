"""The projection kernels: K6, the projection of one camera, and K7, its
backward; and the projection with a gradient that joins them.

The port's own kernels, with no Pallas counterpart: the JAX package
projects in jnp that XLA fuses and differentiates (``multiview_inpaint_tpu
/ops/rasterizer/geometry.py``). K6's plain version, ``project_ref``, is
the projection as the render has always computed it: ``GaussianParams``'
activations, then ``geometry.project_gaussians``. The CUDA source is
``csrc/project.cu``: the activations, the view and clip transforms, the
EWA covariance, the culls and the SH colours of every row in one launch,
read straight from the raw parameters (no concatenation of the SH stack,
no copy of the scale bound to the card), rounded operation by operation
as the plain path rounds, so that radius, extent and visibility are the
plain path's exactly.

``project`` takes the plain version on CPU tensors (counted
``project.plain``, as ``api.project`` counts its plain ops) and launches
K6 on CUDA tensors (counted ``launch.project``); any other device
raises. It computes no gradient.

K7 (``csrc/project_bwd.cu``, wrapper ``project_bwd``, counted
``launch.project_bwd``) takes the cotangents of means2d, conic, depth,
colour and opacity and writes the gradients of the six parameter fields
and of ``means2d_offset`` in one launch, recomputing each row's forward
in registers. Its plain version, ``project_bwd_ref``, is the same chain
in plain ops, which CPU tensors take. A culled or dead row (radius 0)
gets zero gradients: the render gives it no cotangent, and the chain
through its projection may hold infinities (a row in the camera's
plane) that autograd would turn into 0 * inf.

``project_grad`` is the projection with a gradient as one
``torch.autograd.Function``: ``project`` forward (K6), ``project_bwd``
backward (K7), their plain versions on CPU tensors. It records no graph
of plain ops and keeps only its inputs and the radius for the backward.
``api.project`` takes it for every projection. It has no gradient for the
camera's tensors: where one of them requires a gradient ``api.project``
takes the plain ops on CPU tensors and refuses CUDA ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from ... import kernels as _kernels
from ... import telemetry
from ...gs.gaussians import FIELDS, PARAM_FIELDS, GaussianParams
from ...utils import sh as sh_utils
from .geometry import ProjectedGaussians, project_gaussians

# The differentiable fields of ``ProjectedGaussians`` whose cotangents
# K7 reads, in its argument order, with their widths.
COTANGENTS = (("means2d", 2), ("conic", 3), ("depth", 1), ("color", 3),
              ("opacity", 1))


class ProjectionGrads(NamedTuple):
    """The gradients K7 writes: the six parameter fields' and
    ``means2d_offset``'s (None where the projection had no offset)."""
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    opacity: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    means2d_offset: Optional[torch.Tensor]


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


def _view_args(params: GaussianParams, camera, sh_degree: int,
               scaling_modifier: float) -> tuple:
    """The camera and the rows' sizes as K6 and K7 take them."""
    w, h = camera.width, camera.height
    return (params.capacity, params.features_rest.shape[1] * 3, sh_degree,
            float(w), float(h), w / (2.0 * camera.tan_fovx),
            h / (2.0 * camera.tan_fovy), 1.3 * camera.tan_fovx,
            1.3 * camera.tan_fovy, float(scaling_modifier))


def _camera_tensors(camera) -> list:
    return [t.contiguous() for t in (camera.world_view, camera.full_proj,
                                     camera.campos)]


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
    cam = _camera_tensors(camera)
    rc = _kernels.library().mvi_project(
        *(t.data_ptr() for t in ins + cam),
        *_view_args(params, camera, sh_degree, scaling_modifier),
        *(t.data_ptr() for t in (means2d, conic, depth, radius, color,
                                 opacity, extent)),
        _kernels.stream_ptr(dev))
    _kernels.check(rc, "project")
    telemetry.count("launch.project")
    return ProjectedGaussians(means2d=means2d, conic=conic, depth=depth,
                              radius=radius, color=color, opacity=opacity,
                              extent=extent)


def _sh_basis(deg: int, x, y, z) -> list:
    """``utils.sh.eval_sh``'s basis functions 1 .. (deg+1)^2 - 1 at the
    directions (x, y, z), each as (value, (d/dx, d/dy, d/dz))."""
    c1, c2, c3 = sh_utils.C1, sh_utils.C2, sh_utils.C3
    terms = []
    if deg > 0:
        terms += [(-c1 * y, (0.0, -c1, 0.0)), (c1 * z, (0.0, 0.0, c1)),
                  (-c1 * x, (-c1, 0.0, 0.0))]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [
            (c2[0] * xy, (c2[0] * y, c2[0] * x, 0.0)),
            (c2[1] * yz, (0.0, c2[1] * z, c2[1] * y)),
            (c2[2] * (2.0 * zz - xx - yy),
             (-2.0 * c2[2] * x, -2.0 * c2[2] * y, 4.0 * c2[2] * z)),
            (c2[3] * xz, (c2[3] * z, 0.0, c2[3] * x)),
            (c2[4] * (xx - yy), (2.0 * c2[4] * x, -2.0 * c2[4] * y, 0.0))]
    if deg > 2:
        terms += [
            (c3[0] * y * (3 * xx - yy),
             (6.0 * c3[0] * xy, 3.0 * c3[0] * (xx - yy), 0.0)),
            (c3[1] * xy * z, (c3[1] * yz, c3[1] * xz, c3[1] * xy)),
            (c3[2] * y * (4 * zz - xx - yy),
             (-2.0 * c3[2] * xy, c3[2] * (4 * zz - xx - 3 * yy),
              8.0 * c3[2] * yz)),
            (c3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             (-6.0 * c3[3] * xz, -6.0 * c3[3] * yz,
              c3[3] * (6 * zz - 3 * xx - 3 * yy))),
            (c3[4] * x * (4 * zz - xx - yy),
             (c3[4] * (4 * zz - 3 * xx - yy), -2.0 * c3[4] * xy,
              8.0 * c3[4] * xz)),
            (c3[5] * z * (xx - yy),
             (2.0 * c3[5] * xz, -2.0 * c3[5] * yz, c3[5] * (xx - yy))),
            (c3[6] * x * (xx - 3 * yy),
             (3.0 * c3[6] * (xx - yy), -6.0 * c3[6] * xy, 0.0))]
    return terms


def project_bwd_ref(params: GaussianParams, camera, sh_degree: int,
                    scaling_modifier: float, radius: torch.Tensor,
                    cotangents: Sequence[Optional[torch.Tensor]],
                    with_offset: bool = True) -> ProjectionGrads:
    """Plain version of K7: the gradients of the projection's inputs from
    the cotangents of (means2d, conic, depth, color, opacity) (None for
    zero), the chain written out over every row; rows with ``radius`` 0
    get zeros."""
    f32 = torch.float32
    n = params.capacity
    dev = params.xyz.device
    g_m, g_con, g_d, g_col, g_op = (
        torch.zeros((n, k) if k > 1 else (n,), dtype=f32, device=dev)
        if g is None else g for g, (_, k) in zip(cotangents, COTANGENTS))
    vis = radius > 0
    wv, fp = camera.world_view, camera.full_proj
    w, h = float(camera.width), float(camera.height)
    fx = w / (2.0 * camera.tan_fovx)
    fy = h / (2.0 * camera.tan_fovy)
    limx, limy = 1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy
    p = params.xyz
    px, py, pz = p.unbind(-1)

    def row(m, r):
        return px * m[r, 0] + py * m[r, 1] + pz * m[r, 2] + m[r, 3]

    # The forward, as project_gaussians computes it.
    tx, ty, tz = row(wv, 0), row(wv, 1), row(wv, 2)
    ph0, ph1, pw = row(fp, 0), row(fp, 1), row(fp, 3)
    inv_w = 1.0 / (pw + 1e-7)
    inv_z = 1.0 / tz
    xr, yr = tx * inv_z, ty * inv_z
    cx, cy = torch.clamp(xr, -limx, limx), torch.clamp(yr, -limy, limy)
    txz, tyz = cx * tz, cy * tz
    al, ga = fx * inv_z, fy * inv_z
    be = -fx * txz * inv_z * inv_z
    de = -fy * tyz * inv_z * inv_z
    W = wv[:3, :3]
    m0 = [al * W[0, k] + be * W[2, k] for k in range(3)]
    m1 = [ga * W[1, k] + de * W[2, k] for k in range(3)]
    q = params.rotation
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    nrm = norm.clamp(min=1e-12)
    qn = q / nrm
    n2 = torch.sqrt(torch.sum(qn * qn, dim=-1, keepdim=True) + 1e-12)
    qr = qn / n2
    r, x, y, z = qr.unbind(-1)
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
         [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
         [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)]]
    ls = params.scaling
    ex = torch.exp(torch.minimum(ls, ls.new_full((), 20.0)))
    s = ex * scaling_modifier
    A = [m0[0] * R[0][i] + m0[1] * R[1][i] + m0[2] * R[2][i]
         for i in range(3)]
    B = [m1[0] * R[0][i] + m1[1] * R[1][i] + m1[2] * R[2][i]
         for i in range(3)]
    u = [s[:, i] * A[i] for i in range(3)]
    v = [s[:, i] * B[i] for i in range(3)]
    a = u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + 0.3
    b = u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    c = v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + 0.3
    # A visible row's determinant is positive and finite.
    inv_det = 1.0 / torch.where(vis, a * c - b * b, torch.ones_like(a))
    op = torch.sigmoid(params.opacity[:, 0])

    # means2d, then the clip transform.
    g_mx, g_my = g_m[:, 0], g_m[:, 1]
    g_ph0 = g_mx * (0.5 * w) * inv_w
    g_ph1 = g_my * (0.5 * h) * inv_w
    g_inv_w = 0.5 * (g_mx * w * ph0 + g_my * h * ph1)
    g_pw = -g_inv_w * inv_w * inv_w
    g_p = [fp[0, k] * g_ph0 + fp[1, k] * g_ph1 + fp[3, k] * g_pw
           for k in range(3)]

    # The conic, then the EWA covariance.
    g_c1, g_c2, g_c3 = g_con.unbind(-1)
    g_det = -(c * g_c1 - b * g_c2 + a * g_c3) * inv_det * inv_det
    g_a = inv_det * g_c3 + c * g_det
    g_b = -inv_det * g_c2 - 2.0 * b * g_det
    g_c = inv_det * g_c1 + a * g_det
    g_m0, g_m1 = [0.0] * 3, [0.0] * 3
    g_R = [[None] * 3 for _ in range(3)]
    g_s = []
    for i in range(3):
        g_u = 2.0 * u[i] * g_a + v[i] * g_b
        g_v = u[i] * g_b + 2.0 * v[i] * g_c
        g_s.append(g_u * A[i] + g_v * B[i])
        g_A, g_B = g_u * s[:, i], g_v * s[:, i]
        for k in range(3):
            g_m0[k] = g_m0[k] + g_A * R[k][i]
            g_m1[k] = g_m1[k] + g_B * R[k][i]
            g_R[k][i] = g_A * m0[k] + g_B * m1[k]
    g_al = sum(g_m0[k] * W[0, k] for k in range(3))
    g_be = sum(g_m0[k] * W[2, k] for k in range(3))
    g_ga = sum(g_m1[k] * W[1, k] for k in range(3))
    g_de = sum(g_m1[k] * W[2, k] for k in range(3))
    g_txz = -fx * inv_z * inv_z * g_be
    g_tyz = -fy * inv_z * inv_z * g_de
    g_xr = torch.where((xr >= -limx) & (xr <= limx), g_txz * tz, 0.0)
    g_yr = torch.where((yr >= -limy) & (yr <= limy), g_tyz * tz, 0.0)
    g_inv_z = (fx * g_al + fy * g_ga - 2.0 * fx * txz * inv_z * g_be
               - 2.0 * fy * tyz * inv_z * g_de + g_xr * tx + g_yr * ty)
    g_tx, g_ty = g_xr * inv_z, g_yr * inv_z
    g_tz = g_d + cx * g_txz + cy * g_tyz - g_inv_z * inv_z * inv_z
    g_p = [g_p[k] + W[0, k] * g_tx + W[1, k] * g_ty + W[2, k] * g_tz
           for k in range(3)]

    # The rotation, then its two normalisations, each as autograd chains
    # it (a zero quaternion gets NaN, as there).
    (g00, g01, g02), (g10, g11, g12), (g20, g21, g22) = g_R
    g_qr = 2.0 * torch.stack([
        -z * g01 + y * g02 + z * g10 - x * g12 - y * g20 + x * g21,
        y * g01 + z * g02 + y * g10 - 2 * x * g11 - r * g12 + z * g20
        + r * g21 - 2 * x * g22,
        -2 * y * g00 + x * g01 + r * g02 + x * g10 + z * g12 - r * g20
        + z * g21 - 2 * y * g22,
        -2 * z * g00 - r * g01 + x * g02 + r * g10 - 2 * z * g11 + y * g12
        + x * g20 + y * g21], dim=-1)
    g_qn = (g_qr - qr * torch.sum(g_qr * qr, dim=-1, keepdim=True)) / n2
    g_nrm = -torch.sum(g_qn * q, dim=-1, keepdim=True) / (nrm * nrm)
    g_norm = torch.where(norm >= 1e-12, g_nrm, 0.0)
    g_q = g_qn / nrm + q * (g_norm / norm)

    # The scale: minimum's ties split, exp, the modifier.
    tie = torch.where(ls < 20.0, 1.0, torch.where(ls == 20.0, 0.5, 0.0))
    tie = torch.where(torch.isnan(ls), 1.0, tie)
    g_ls = torch.stack(g_s, dim=-1) * scaling_modifier * ex * tie

    g_o = g_op * (1.0 - op) * op

    # The colour: clamp(min=0), the SH basis, the view direction.
    ncoef = (sh_degree + 1) ** 2
    sh = params.features()[:, :ncoef]                       # [N, K, 3]
    if sh_degree > 0:
        e = [px - camera.campos[0], py - camera.campos[1],
             pz - camera.campos[2]]
        sq = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
        inv_n = torch.rsqrt(torch.clamp(sq, min=1e-24))
        dirs = torch.stack([e[0] * inv_n, e[1] * inv_n, e[2] * inv_n], -1)
        terms = _sh_basis(sh_degree, *dirs.unbind(-1))
        basis = torch.stack([torch.full_like(sq, sh_utils.C0)]
                            + [t[0] for t in terms], dim=-1)
    else:
        dirs, terms = torch.zeros_like(p), []
        basis = torch.full((n, 1), sh_utils.C0, dtype=f32, device=dev)
    # The clamp's side is decided on the forward's own colour.
    rgb = sh_utils.eval_sh(sh_degree, sh.transpose(-1, -2), dirs)
    g_rgb = torch.where(rgb + 0.5 >= 0.0, g_col, 0.0)          # [N, 3]
    g_sh = basis[:, :, None] * g_rgb[:, None, :]              # [N, K, 3]
    g_rest = torch.zeros_like(params.features_rest)
    g_rest[:, :ncoef - 1] = g_sh[:, 1:]
    if terms:
        per = torch.sum(g_rgb[:, None, :] * sh[:, 1:], dim=-1)  # [N, K-1]
        g_dir = [sum(per[:, j] * t[1][axis] for j, t in enumerate(terms))
                 for axis in range(3)]
        g_inv_n = g_dir[0] * e[0] + g_dir[1] * e[1] + g_dir[2] * e[2]
        g_sq = torch.where(sq >= 1e-24,
                           -0.5 * g_inv_n * inv_n * inv_n * inv_n, 0.0)
        g_p = [g_p[k] + g_dir[k] * inv_n + 2.0 * e[k] * g_sq
               for k in range(3)]

    def keep(g):
        return torch.where(vis.reshape((n,) + (1,) * (g.dim() - 1)), g, 0.0)

    return ProjectionGrads(
        xyz=keep(torch.stack(g_p, dim=-1)),
        features_dc=keep(g_sh[:, :1]), features_rest=keep(g_rest),
        opacity=keep(g_o[:, None]), scaling=keep(g_ls),
        rotation=keep(g_q), means2d_offset=keep(g_m) if with_offset else None)


def _cotangent(g: Optional[torch.Tensor], n: int, k: int, dev) -> tuple:
    """(pointer, row stride in floats, tensor) of a cotangent K7 reads:
    (0, 0, None) for None, else the tensor as it is where its rows'
    floats are contiguous (a column slice of the packed attributes'
    gradient), else a copy."""
    if g is None:
        return 0, 0, None
    shape = (n, k) if k > 1 else (n,)
    if g.dtype != torch.float32 or tuple(g.shape) != shape \
            or g.device != dev:
        raise ValueError(f"project_bwd: a cotangent must be float32 "
                         f"{shape} on {dev}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    if k > 1 and g.stride(1) != 1:
        g = g.contiguous()
    return g.data_ptr(), g.stride(0), g


def project_bwd(params: GaussianParams, camera, sh_degree: int,
                scaling_modifier: float, radius: torch.Tensor,
                cotangents: Sequence[Optional[torch.Tensor]],
                with_offset: bool = True) -> ProjectionGrads:
    """The projection's backward (``project_bwd_ref``'s result). CPU
    tensors take the plain version; CUDA tensors launch K7 on the current
    stream, which nothing waits for."""
    dev = params.xyz.device
    if dev.type == "cpu":
        return project_bwd_ref(params, camera, sh_degree, scaling_modifier,
                               radius, cotangents, with_offset)
    if dev.type != "cuda":
        raise ValueError(f"project_bwd: unsupported device {dev}")
    _check(params, camera, sh_degree)
    n = params.capacity
    if radius.dtype != torch.int32 or tuple(radius.shape) != (n,) \
            or radius.device != dev:
        raise ValueError(f"project_bwd: radius must be int32 ({n},) on "
                         f"{dev}")
    cots = [_cotangent(g, n, k, dev)
            for g, (_, k) in zip(cotangents, COTANGENTS)]
    ins = [getattr(params, f).contiguous() for f in PARAM_FIELDS]
    ins += [radius.contiguous()] + _camera_tensors(camera)
    grads = [torch.empty_like(t) for t in ins[:len(PARAM_FIELDS)]]
    offset = (torch.empty((n, 2), dtype=torch.float32, device=dev)
              if with_offset else None)
    rc = _kernels.library().mvi_project_bwd(
        *(t.data_ptr() for t in ins),
        *_view_args(params, camera, sh_degree, scaling_modifier),
        *(x for ptr, stride, _ in cots for x in (ptr, stride)),
        *(t.data_ptr() for t in grads),
        0 if offset is None else offset.data_ptr(),
        _kernels.stream_ptr(dev))
    _kernels.check(rc, "project_bwd")
    telemetry.count("launch.project_bwd")
    return ProjectionGrads(*grads, means2d_offset=offset)


class _ProjectFn(torch.autograd.Function):
    """K6 forward, K7 backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, live, camera, sh_degree, scaling_modifier,
                means2d_offset, *fields):
        params = GaussianParams(*fields, live=live)
        proj = project(params, camera, sh_degree, scaling_modifier)
        means2d = proj.means2d
        if means2d_offset is not None:
            # Added to the visible rows' centres, as project_gaussians
            # adds it before its culls (a culled row's centre stays 0).
            means2d = torch.where((proj.radius > 0)[:, None],
                                  means2d + means2d_offset, means2d)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(proj.radius, proj.extent)
        ctx.save_for_backward(live, proj.radius, *fields)
        ctx.view = (camera, sh_degree, scaling_modifier,
                    means2d_offset is not None)
        return (means2d, proj.conic, proj.depth, proj.radius, proj.color,
                proj.opacity, proj.extent)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_means2d, g_conic, g_depth, _radius, g_color,
                 g_opacity, _extent):
        live, radius, *fields = ctx.saved_tensors
        camera, sh_degree, scaling_modifier, with_offset = ctx.view
        grads = project_bwd(GaussianParams(*fields, live=live), camera,
                            sh_degree, scaling_modifier, radius,
                            (g_means2d, g_conic, g_depth, g_color,
                             g_opacity), with_offset)
        need = ctx.needs_input_grad
        return (None, None, None, None,
                grads.means2d_offset if need[4] else None,
                *(g if need[5 + i] else None
                  for i, g in enumerate(grads[:len(PARAM_FIELDS)])))


def project_grad(params: GaussianParams, camera, sh_degree: int,
                 scaling_modifier: float = 1.0,
                 means2d_offset: Optional[torch.Tensor] = None
                 ) -> ProjectedGaussians:
    """``project_ref``'s projection, differentiable in the six parameter
    fields and ``means2d_offset`` through one autograd node: K6 forward
    and K7 backward on CUDA tensors, their plain versions on CPU ones.
    The camera's tensors get no gradient."""
    return ProjectedGaussians(*_ProjectFn.apply(
        params.live, camera, sh_degree, scaling_modifier, means2d_offset,
        *(getattr(params, f) for f in PARAM_FIELDS)))
