"""Seeded Gaussian scenes and orbit cameras, made on the device.

A frozen copy of the layout of the port's ``utils/synthetic.make_big_scene``
(a densified Mip-NeRF 360 capture's size: clustered foreground blobs, a
ground plane and a far background shell, splats small enough for ~2-4
pairs per splat at 1080p), drawn with a ``torch.Generator`` on the device
in a few bulk calls. The layout (positions, scales, rotations, opacities)
comes from the configuration's fixed ``layout_seed``, so that every run
seed gives the rasterizer the same splats to project, bin and composite;
the run's seed draws the order of the rows and the SH rest coefficients.
Both the program and the reference get these tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation")
SH_C0 = 0.28209479177387814
ZNEAR, ZFAR = 0.01, 100.0


def _uniform(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def make_scene(n: int, sh_degree: int, layout_seed: int, seed: int, device,
               rest_std: float = 0.05) -> dict:
    """{field: float32 tensor} of n live splats: the layout of
    ``layout_seed`` in an order drawn from ``seed``, with rest
    coefficients drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(layout_seed)
    n_core, n_plane = int(n * 0.55), int(n * 0.25)
    n_shell = n - n_core - n_plane
    k = 40
    centers = _uniform(g, (k, 3), -1.2, 1.2, device) * torch.tensor(
        [1.0, 1.0, 0.6], device=device)
    idx = torch.randint(0, k, (n_core,), generator=g, device=device)
    core = centers[idx] + 0.25 * torch.randn((n_core, 3), generator=g,
                                             device=device)
    u = torch.rand((n_plane, 3), generator=g, device=device)
    plane = torch.stack([u[:, 0] * 6 - 3, u[:, 1] * 0.2 - 1.6,
                         u[:, 2] * 6 - 3], -1)
    u = torch.rand((n_shell, 3), generator=g, device=device)
    r = 4.0 + 2.0 * u[:, 0]
    theta = 2 * math.pi * u[:, 1]
    phi = torch.arccos(2 * u[:, 2] - 1)
    shell = torch.stack([r * torch.sin(phi) * torch.cos(theta),
                         r * torch.sin(phi) * torch.sin(theta),
                         r * torch.cos(phi)], -1)
    xyz = torch.cat([core, plane, shell])
    rgb = torch.tanh(xyz * 0.4) * 0.5 + 0.5
    dc = ((rgb - 0.5) / SH_C0).reshape(n, 1, 3)
    scales = _uniform(g, (n, 3), 0.0015, 0.008, device)
    scales[n_core + n_plane:] *= 4.0   # far shell: similar screen size
    op = _uniform(g, (n, 1), 0.5, 0.95, device)
    rot = torch.randn((n, 4), generator=g, device=device)
    rot = rot / rot.norm(dim=-1, keepdim=True)
    g = torch.Generator(device=device).manual_seed(seed)
    order = torch.randperm(n, generator=g, device=device)
    m = (sh_degree + 1) ** 2 - 1
    rest = rest_std * torch.randn((n, m, 3), generator=g, device=device)
    return {"xyz": xyz[order].contiguous(),
            "features_dc": dc[order].contiguous(), "features_rest": rest,
            "opacity": torch.log(op / (1 - op))[order],
            "scaling": torch.log(scales)[order], "rotation": rot[order]}


def perturb(scene: dict, seed: int, device, xyz_std=0.002, dc_std=0.05,
            opacity_std=0.2) -> dict:
    """A nearby scene (the training targets' source)."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = dict(scene)
    for f, std in (("xyz", xyz_std), ("features_dc", dc_std),
                   ("opacity", opacity_std)):
        out[f] = scene[f] + std * torch.randn(
            scene[f].shape, generator=g, device=device)
    return out


class Camera(NamedTuple):
    world_view: torch.Tensor   # [4, 4] column-vector world -> camera
    full_proj: torch.Tensor    # [4, 4] projection @ world_view
    campos: torch.Tensor       # [3]
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


def _projection(fovx, fovy):
    p = torch.zeros((4, 4), dtype=torch.float64)
    p[0, 0] = 1.0 / math.tan(fovx / 2)
    p[1, 1] = 1.0 / math.tan(fovy / 2)
    p[3, 2] = 1.0
    p[2, 2] = ZFAR / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return p


def orbit_cameras(views: int, yaw_span: float, distance: float, width: int,
                  height: int, fovx: float, fovy: float, seed: int,
                  device) -> list:
    """``views`` cameras turned about world y by yaws evenly spaced over
    [-yaw_span, yaw_span], each ``distance`` from the origin looking at
    it (COLMAP convention, as the port's bench camera), in an order
    drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    order = torch.randperm(views, generator=g).tolist()
    proj = _projection(fovx, fovy)
    cams = []
    for i in order:
        yaw = -yaw_span + 2 * yaw_span * i / max(views - 1, 1)
        c, s = math.cos(yaw), math.sin(yaw)
        rot = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                           dtype=torch.float64)
        wv = torch.eye(4, dtype=torch.float64)
        wv[:3, :3] = rot.T
        wv[:3, 3] = torch.tensor([0.0, 0.0, distance], dtype=torch.float64)
        campos = torch.linalg.inv(wv)[:3, 3]

        def t(a):
            return a.to(torch.float32).to(device)

        cams.append(Camera(t(wv), t(proj @ wv), t(campos),
                           math.tan(fovx / 2), math.tan(fovy / 2), width,
                           height))
    return cams


def camera_extent(cams) -> float:
    """graphdeco's ``getNerfppNorm`` radius: 1.1 x the largest distance of
    a camera centre from their mean (the xyz learning-rate scale)."""
    centres = torch.stack([c.campos for c in cams]).double()
    return float((centres - centres.mean(0)).norm(dim=1).max()) * 1.1
