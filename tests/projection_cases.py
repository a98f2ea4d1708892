"""A scene whose rows take every branch of the projection, for the tests
that hold the projection kernel (K6) against its plain version: rows in
front of the camera and behind it, at the near plane, beyond the 1.3
tan-fov clamp and in the camera's plane, dead rows, rows with NaN or
infinite parameters (the non-finite quarantine), log-scales above the
clamp at 20, a zero quaternion and opacities at both ends; and, for the
tests of the projection's backward (K7), that scene with a log-scale at
the clamp's bound exactly and seeded cotangents on its visible rows.
Imports torch and the port only.
"""

import numpy as np
import torch

from multiview_inpaint_tpu_torch.gs import cameras, gaussians
from multiview_inpaint_tpu_torch.ops.rasterizer import project_cuda

WIDTH, HEIGHT = 96, 64


def camera():
    """A 96x64 view from z = -4 along +z: view depth = z + 4."""
    return cameras.make_camera(0, np.eye(3), np.array([0.0, 0, 4.0]),
                               fovx=0.8, fovy=0.7, width=WIDTH,
                               height=HEIGHT)


def hard_scene(n=2000, max_sh_degree=3, seed=0, device="cpu"):
    """``n`` live rows (the special ones first) and 16 dead rows after
    them, SH rest coefficients up to ``max_sh_degree``."""
    rng = np.random.default_rng(seed)
    m = (max_sh_degree + 1) ** 2 - 1
    xyz = rng.uniform(-1.5, 1.5, size=(n, 3))
    xyz[:, 2] = rng.uniform(-1.0, 3.0, size=n)
    dc = rng.normal(size=(n, 1, 3))
    rest = 0.3 * rng.normal(size=(n, m, 3))
    opacity = 3.0 * rng.normal(size=(n, 1))
    scaling = np.log(rng.uniform(0.01, 0.3, size=(n, 3)))
    rotation = rng.normal(size=(n, 4))
    xyz[0] = (0.1, 0.2, -4.5)               # behind the camera
    xyz[1] = (0.0, 0.0, -3.8)               # at the near plane
    xyz[14] = (0.3, 0.1, -4.0)              # in the camera's plane
    xyz[2] = (3.0, 0.5, 0.0)                # beyond the x clamp
    xyz[3] = (-0.2, -2.5, 0.0)              # beyond the y clamp
    xyz[4] = np.nan                         # non-finite quarantine
    xyz[5, 0] = np.inf
    scaling[6, 1] = np.nan
    scaling[7] = (25.0, -3.0, -3.0)         # log-scale above 20
    scaling[8] = 22.0
    rotation[9] = 0.0                       # zero quaternion
    opacity[10] = -40.0                     # below 1/255 everywhere
    opacity[11] = 40.0
    scaling[12] = -15.0                     # far under a pixel
    p = gaussians.from_arrays(
        xyz.astype(np.float32), dc.astype(np.float32),
        rest.astype(np.float32), opacity.astype(np.float32),
        scaling.astype(np.float32), rotation.astype(np.float32),
        capacity=n + 16, device=device)
    p.live[13] = False                      # a dead row among live ones
    return p


def grad_scene(n=500, max_sh_degree=3, seed=0, device="cpu"):
    """``hard_scene`` with a log-scale at the clamp's bound, 20, where
    ``torch.minimum`` splits its gradient in halves: on row 15, whose
    long axis points along the view a hair off its centre line, so that
    it covers about a pixel and its covariance stays well conditioned,
    and on row 16, among random rows; and row 17 at view depth 1 with
    x / z on the 1.3 tan-fov clamp's bound exactly, where
    ``torch.clamp`` passes the gradient."""
    p = hard_scene(n=n, max_sh_degree=max_sh_degree, seed=seed,
                   device=device)
    p.xyz[15] = torch.tensor([1e-9, 0.0, 0.0])
    p.scaling[15] = torch.tensor([-3.0, -3.0, 20.0])
    p.rotation[15] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    p.scaling[16, 0] = 20.0
    p.xyz[17] = torch.tensor([float(np.float32(
        1.3 * camera().tan_half_fovx)), 0.1, -3.0])
    return p


def cotangents(proj, seed=0):
    """Seeded normal cotangents of (means2d, conic, depth, color,
    opacity), zero on the rows the projection culled: the render gives
    those no cotangent."""
    vis = proj.radius > 0
    g = torch.Generator().manual_seed(seed)
    out = []
    for _, k in project_cuda.COTANGENTS:
        shape = (vis.shape[0], k) if k > 1 else (vis.shape[0],)
        c = torch.randn(shape, generator=g).to(vis.device)
        out.append(c * (vis[:, None] if k > 1 else vis))
    return out
