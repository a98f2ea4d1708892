"""Per-gaussian projection geometry: EWA splatting math, dense over N.

Port of ``multiview_inpaint_tpu/ops/rasterizer/geometry.py`` (the
projection/culling stage of the reference's CUDA rasterizer, forward
preprocess). Elementwise tensor code over the padded gaussian buffer,
written in the same operation order as the JAX module so float32 results
agree to rounding.

Conventions (matching the reference pipeline):
- view matrix is column-vector ``x_view = W @ [x;1]``, camera looks along +z;
- frustum cull at ``z <= 0.2``;
- 2D covariance = J W Sigma W^T J^T + 0.3 I (EWA low-pass), J the
  perspective Jacobian with the 1.3*tan_fov frustum clamp on x/z, y/z;
- radius = ceil(3 sqrt(lambda_max)), pixel centre convention
  ``pix = ((ndc+1)*size - 1)/2``;
- SH colours evaluated along campos->gaussian dirs, clamped at 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import sh as sh_utils


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor   # [N, 2] pixel coords
    conic: torch.Tensor     # [N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor     # [N] view-space z
    radius: torch.Tensor    # [N] int32 pixel radius (0 = culled)
    color: torch.Tensor     # [N, 3] RGB from SH
    opacity: torch.Tensor   # [N] activated opacity, 0 for culled/dead
    # [N, 2] per-axis half-extents of the opacity-aware k-sigma ellipse's
    # AABB (k <= 3): the rect the binning uses.
    extent: torch.Tensor


def project_gaussians(
    xyz: torch.Tensor,            # [N, 3]
    features: torch.Tensor,       # [N, K, 3] SH stack (DC first)
    opacity: torch.Tensor,        # [N] activated (sigmoid) opacity
    scaling: torch.Tensor,        # [N, 3] activated (exp) scale
    rotation: torch.Tensor,       # [N, 4] quaternion
    live: torch.Tensor,           # [N] bool
    world_view: torch.Tensor,     # [4, 4]
    full_proj: torch.Tensor,      # [4, 4]
    campos: torch.Tensor,         # [3]
    tan_fovx: float, tan_fovy: float,
    width: int, height: int,
    sh_degree: int,
    scaling_modifier: float = 1.0,
    means2d_offset: Optional[torch.Tensor] = None,
) -> ProjectedGaussians:
    """Dense projection of all (padded) gaussians for one camera.

    ``means2d_offset`` [N,2] (pixels) is added to the projected centres;
    pass zeros with ``requires_grad`` to read the screen-space mean
    gradients that drive densification.
    """
    f32 = torch.float32
    xyz = xyz.to(f32)
    px, py, pz = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    wv = world_view
    tx = px * wv[0, 0] + py * wv[0, 1] + pz * wv[0, 2] + wv[0, 3]
    ty = px * wv[1, 0] + py * wv[1, 1] + pz * wv[1, 2] + wv[1, 3]
    tz = px * wv[2, 0] + py * wv[2, 1] + pz * wv[2, 2] + wv[2, 3]
    in_front = tz > 0.2

    # Clip space -> pixel centres.
    fp = full_proj
    ph0 = px * fp[0, 0] + py * fp[0, 1] + pz * fp[0, 2] + fp[0, 3]
    ph1 = px * fp[1, 0] + py * fp[1, 1] + pz * fp[1, 2] + fp[1, 3]
    pw = px * fp[3, 0] + py * fp[3, 1] + pz * fp[3, 2] + fp[3, 3]
    inv_w = 1.0 / (pw + 1e-7)
    means2d = torch.stack([((ph0 * inv_w + 1) * width - 1) * 0.5,
                           ((ph1 * inv_w + 1) * height - 1) * 0.5], dim=-1)
    if means2d_offset is not None:
        means2d = means2d + means2d_offset

    # EWA 2D covariance, scalarised: cov2d = (M L)(M L)^T with
    # L = R diag(s*mod) and M = J W, J the perspective Jacobian.
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    inv_z = 1.0 / tz
    txz = torch.clamp(tx * inv_z, -limx, limx) * tz
    tyz = torch.clamp(ty * inv_z, -limy, limy) * tz
    al = focal_x * inv_z
    be = -focal_x * txz * inv_z * inv_z
    ga = focal_y * inv_z
    de = -focal_y * tyz * inv_z * inv_z
    W = world_view[:3, :3]
    m0 = [al * W[0, k] + be * W[2, k] for k in range(3)]
    m1 = [ga * W[1, k] + de * W[2, k] for k in range(3)]

    q = rotation.to(f32)
    qn = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)
    r, x, y, z = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
         [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
         [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)]]
    s = scaling.to(f32) * scaling_modifier
    a = torch.zeros_like(tz)
    b = torch.zeros_like(tz)
    c = torch.zeros_like(tz)
    for i in range(3):
        u = s[:, i] * (m0[0] * R[0][i] + m0[1] * R[1][i] + m0[2] * R[2][i])
        v = s[:, i] * (m1[0] * R[0][i] + m1[1] * R[1][i] + m1[2] * R[2][i])
        a = a + u * u
        b = b + u * v
        c = c + v * v
    a = a + 0.3
    c = c + 0.3

    det = a * c - b * b
    det_ok = det > 0.0
    one = torch.ones_like(det)
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, one),
                          torch.zeros_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))

    # Non-finite quarantine: a row whose params overflowed or went NaN
    # must cull, not poison the shared binning tables.
    finite_ok = (torch.isfinite(det) & torch.isfinite(means2d[:, 0])
                 & torch.isfinite(means2d[:, 1]) & torch.isfinite(tz))
    visible = in_front & det_ok & live & finite_ok
    means2d = torch.where(visible[:, None], means2d,
                          torch.zeros_like(means2d))
    radius_f = torch.clamp(radius_f, max=4.0 * (width + height))
    radius = torch.where(visible, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)
    # Opacity-aware sigma cutoff: alpha = op*exp(-M^2/2) >= 1/255 holds
    # exactly inside the k-sigma ellipse with k = sqrt(2 ln(255 op)),
    # capped at 3 (the reference's 3-sigma outer bound).
    with torch.no_grad():
        k = torch.clamp(torch.sqrt(2.0 * torch.clamp(torch.log(
            255.0 * torch.clamp(opacity, min=1e-12)), min=0.0)), max=3.0)
        ext = torch.ceil(k[:, None] * torch.sqrt(torch.clamp(
            torch.stack([a, c], dim=-1), min=0.0)))
        extent = torch.where(visible[:, None], ext, torch.zeros_like(ext))

    # SH -> RGB along viewing directions (degree 0 is direction-free).
    if sh_degree > 0:
        dx = px - campos[0]
        dy = py - campos[1]
        dz = pz - campos[2]
        inv_n = torch.rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz,
                                        min=1e-24))
        dirs = torch.stack([dx * inv_n, dy * inv_n, dz * inv_n], dim=-1)
    else:
        dirs = torch.zeros_like(xyz)
    rgb = sh_utils.eval_sh(sh_degree, features.transpose(-1, -2), dirs)
    color = torch.clamp(rgb + 0.5, min=0.0)

    return ProjectedGaussians(
        means2d=means2d,
        conic=conic,
        depth=tz,
        radius=radius,
        color=color,
        opacity=torch.where(visible, opacity.to(f32),
                            torch.zeros_like(opacity, dtype=f32)),
        extent=extent,
    )
