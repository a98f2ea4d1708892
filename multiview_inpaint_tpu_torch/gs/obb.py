"""Oriented bounding box: OBJ cube parsing and batched ray intersection.

Port of ``multiview_inpaint_tpu/gs/obb.py`` (reference ``torchMesh``,
``gs-simp/utils/bounding.py:4-142``): the user-placed OBB that drives
object deletion, orbit-mask generation and new-gaussian seeding. The
loader is a numpy copy; the intersection runs in torch on the rays'
device.

Semantics preserved:
- OBJ vertices are loaded with the Y/Z axis flip ``(x, -z, y)``
  (``inverse=True``), quads split into two triangles.
- Three box axes + origin corner are recovered from the first faces so
  ``origin + sum_i u_i * axes_i`` (u in [0,1]^3) spans the box.
- ``intersect`` normalises ray dirs (a zero direction is a miss) and
  returns the nearest positive-t hit (Moller-Trumbore, eps=1e-8) with a
  hit mask; misses give t=0. The arithmetic is the JAX function's, term
  for term; the rays go through in chunks of ``RAY_CHUNK`` (each ray is
  independent), which bounds the [rays, 12] temporaries at 1080p.
- ``contains`` implements del.py's point-in-box test: a point is inside iff
  rays in both +x and -x directions hit the box (``del.py:105-117``).

Float32 rounding of the crosses and the 3-term sums may differ between
the CPU, CUDA and XLA, so a hit decision can differ only on a ray that
grazes a triangle's edge or starts on a face; ``fragile_rays`` finds
those in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

RAY_CHUNK = 1 << 20
FRAGILE_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class OBB:
    vertices: np.ndarray   # [8, 3]
    faces: np.ndarray      # [12, 3] int
    face_verts: np.ndarray  # [12, 3, 3]
    axes: np.ndarray       # [3, 3] edge vectors spanning the box
    origin: np.ndarray     # [3] corner
    center: np.ndarray     # [3]


def load_obb(path: str, inverse: bool = True) -> OBB:
    """Parse a cube OBJ exported from Blender (quads, 8 vertices)."""
    verts, faces = [], []
    p1 = p2 = p3 = p4 = p5 = None
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                x = [float(t) for t in line.split()[1:]]
                verts.append([x[0], -x[2], x[1]] if inverse else x[:3])
            elif line.startswith("f "):
                ids = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                v1, v2, v3, v4 = ids
                faces.append([v1, v2, v3])
                faces.append([v1, v3, v4])
                if p1 is None:
                    p1, p2, p3 = v1, v2, v3
                elif v2 in (p2, p3) and v3 in (p2, p3):
                    p4, p5 = v3, v4
                elif v1 in (p2, p3) and v2 in (p2, p3):
                    p4, p5 = v2, v3
                elif v3 in (p2, p3) and v4 in (p2, p3):
                    p4, p5 = v3, v2
                elif v1 in (p2, p3) and v4 in (p2, p3):
                    p4, p5 = v1, v2
    v = np.asarray(verts, np.float32)
    fc = np.asarray(faces, np.int32)
    axes = np.stack([v[p3] - v[p2], v[p1] - v[p2], v[p5] - v[p4]])
    origin = v[p2]
    center = origin + axes.sum(axis=0) * 0.5
    return OBB(vertices=v, faces=fc, face_verts=v[fc], axes=axes,
               origin=origin, center=center)


def from_center_axes(center: np.ndarray, axes: np.ndarray) -> OBB:
    """Build an OBB from a center and three (full-length) axis vectors."""
    origin = np.asarray(center) - 0.5 * np.asarray(axes).sum(axis=0)
    corners = np.array([origin + a * axes[0] + b * axes[1] + c * axes[2]
                        for a in (0, 1) for b in (0, 1) for c in (0, 1)],
                       dtype=np.float32)
    # Faces of the unit-cube corner ordering above (each quad -> 2 tris).
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for q in quads:
        faces.append([q[0], q[1], q[2]])
        faces.append([q[0], q[2], q[3]])
    fc = np.asarray(faces, np.int32)
    return OBB(vertices=corners, faces=fc, face_verts=corners[fc],
               axes=np.asarray(axes, np.float32),
               origin=origin.astype(np.float32),
               center=np.asarray(center, np.float32))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` of 3-vectors, in its order of terms."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of 3, left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _intersect(face_verts: torch.Tensor, rayo: torch.Tensor,
               rayd: torch.Tensor, eps: float = 1e-8):
    """Moller-Trumbore over all rays x faces. rayd must be normalised.

    Returns (t [N], hit [N]) with t=0 on miss.
    """
    v0 = face_verts[:, 0]                       # [F,3]
    edge1 = face_verts[:, 1] - v0               # [F,3]
    edge2 = face_verts[:, 2] - v0               # [F,3]
    h = _cross(rayd[:, None, :], edge2[None])             # [N,F,3]
    a = _dot(edge1[None], h)                              # [N,F]
    f = 1.0 / (a + eps)
    s = rayo[:, None, :] - v0[None]                       # [N,F,3]
    u = f * _dot(s, h)
    q = _cross(s, edge1[None])
    v = f * _dot(rayd[:, None, :], q)
    t = f * _dot(edge2[None], q)                          # [N,F]
    miss = ((a.abs() < eps) | (u < 0) | (u > 1)
            | (v < 0) | (u + v > 1) | (t < eps))
    max_t = t.amax(dim=-1, keepdim=True)
    t_masked = torch.where(miss, max_t + 1, t)
    int_t = t_masked.amin(dim=-1)
    hit = (max_t[:, 0] + 1 - int_t) > 0
    return torch.where(hit, int_t, torch.zeros_like(int_t)), hit


def intersect(obb: OBB, rayo: torch.Tensor, rayd: torch.Tensor):
    """Nearest positive-t box hit for each ray, on the rays' device.

    Returns (points [N,3], t [N], hit [N]); t along the *normalised* dir.
    """
    rayd = rayd / torch.sqrt(_dot(rayd, rayd))[:, None].clamp(min=1e-12)
    fv = torch.as_tensor(obb.face_verts, dtype=torch.float32,
                         device=rayo.device)
    ts, hits = [], []
    for lo in range(0, max(rayo.shape[0], 1), RAY_CHUNK):
        t, hit = _intersect(fv, rayo[lo:lo + RAY_CHUNK],
                            rayd[lo:lo + RAY_CHUNK])
        ts.append(t)
        hits.append(hit)
    t, hit = torch.cat(ts), torch.cat(hits)
    pts = torch.where(hit[:, None], rayo + t[:, None] * rayd,
                      torch.zeros_like(rayo))
    return pts, t, hit


def contains(obb: OBB, points: torch.Tensor) -> torch.Tensor:
    """Point-in-box by bidirectional +x/-x ray test (del.py semantics)."""
    d = torch.zeros_like(points)
    d[:, 0] = 1.0
    _, t_pos, hit_pos = intersect(obb, points, d)
    _, t_neg, hit_neg = intersect(obb, points, -d)
    return (t_pos > 0) & (t_neg > 0) & hit_pos & hit_neg


def sample_uniform(obb: OBB, generator: Optional[torch.Generator], n: int,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """n uniform samples inside the box: origin + sum u_i axes_i, with
    ``u`` [n, 3] drawn from ``generator`` (on its device) unless given."""
    if u is None:
        u = torch.rand((n, 3), generator=generator, device=generator.device)
    dev = u.device
    return (torch.as_tensor(obb.origin, device=dev)
            + u @ torch.as_tensor(obb.axes, device=dev))


def fragile_rays(obb: OBB, rayo, rayd) -> np.ndarray:
    """[N] bool: rays whose hit decision rests on float rounding. In
    float64, a ray is fragile when, for a face triangle it is not parallel
    to, it crosses within ``FRAGILE_TOL`` (barycentric) of one of the
    triangle's edges ahead of its origin, or its origin lies within
    ``FRAGILE_TOL`` (along the unit direction) of the triangle.
    ``intersect`` and ``contains`` (whose rays are +-x from each point) can
    only decide such rays differently on different devices."""
    fv = np.asarray(obb.face_verts, np.float64)
    v0 = fv[:, 0]
    e1, e2 = fv[:, 1] - v0, fv[:, 2] - v0
    o = np.asarray(rayo, np.float64)
    d = np.asarray(rayd, np.float64)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    tol, chunk = FRAGILE_TOL, 1 << 18
    out = np.zeros(len(o), bool)
    for lo in range(0, len(o), chunk):
        oc, dc = o[lo:lo + chunk], d[lo:lo + chunk]
        h = np.cross(dc[:, None], e2[None])
        a = np.einsum("fk,nfk->nf", e1, h)
        ok = np.abs(a) >= 1e-8
        f = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
        s = oc[:, None] - v0[None]
        u = f * np.einsum("nfk,nfk->nf", s, h)
        q = np.cross(s, e1[None])
        v = f * np.einsum("nk,nfk->nf", dc, q)
        t = f * np.einsum("fk,nfk->nf", e2, q)
        margin = np.minimum(np.minimum(u, v), 1.0 - u - v)
        edge = (np.abs(margin) < tol) & (t > -tol)
        on_face = (margin > -tol) & (np.abs(t) < tol)
        out[lo:lo + chunk] = np.any(ok & (edge | on_face), axis=-1)
    return out
