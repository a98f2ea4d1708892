"""Synthetic scenes for tests, smoke runs and measurements.

Port of ``multiview_inpaint_tpu/utils/synthetic.py`` plus the 100k-splat
bench ball and bench camera of the repo's ``bench.py``. Every scene is
made from a numpy seed (the same draws as the JAX package's), so the two
packages build the same gaussians; ``device`` says where the tensors go.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..gs import cameras, colmap, gaussians, scene_io
from ..utils import graphics
from ..utils.device import DEFAULT_DEVICE
from . import sh as sh_utils
from .schedules import inverse_sigmoid

BENCH_WIDTH, BENCH_HEIGHT = 1920, 1080
BENCH_FOVX, BENCH_FOVY = 1.1, 0.7


def _logit32(p) -> np.ndarray:
    """float32 logit, rounded as the JAX package's f32 computation."""
    return inverse_sigmoid(torch.as_tensor(
        np.asarray(p, np.float32))).numpy()


def _identity_rots(n: int) -> np.ndarray:
    return np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))


def make_gt_gaussians(n=32, seed=0, capacity=None, spread=0.8,
                      device=DEFAULT_DEVICE):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    rgb = rng.random((n, 3)).astype(np.float32)
    dc = sh_utils.rgb_to_sh(rgb).reshape(n, 1, 3)
    return gaussians.from_arrays(
        xyz, dc, np.zeros((n, 0, 3), np.float32),
        np.full((n, 1), float(_logit32(0.85))),
        np.full((n, 3), np.log(0.15), np.float32),
        _identity_rots(n), capacity=capacity, device=device)


def orbit_pose(angle, radius=3.0, height=0.0):
    """(R, T) colmap-convention for a camera on a circle looking at origin."""
    pos = np.array([radius * np.sin(angle), height,
                    -radius * np.cos(angle)])
    z = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R_c2w = np.stack([x, y, z], axis=1)
    w2c_R = R_c2w.T
    T = -w2c_R @ pos
    return R_c2w, T  # reference CameraInfo stores R = c2w rotation


def _write_colmap(root, width, height, fx, fy, views, points, colors):
    """Write a PINHOLE COLMAP scene: sparse/0/{cameras,images,points3D}.bin
    and images/<name> for each (name, R_c2w, T, image) of ``views``."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", width, height,
                                   np.array([fx, fy, width / 2,
                                             height / 2]))}
    images = {}
    for i, (name, R_c2w, T, img) in enumerate(views):
        # colmap stores the w2c rotation
        images[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat2qvec(R_c2w.T), T, 1, name)
        scene_io.save_image(os.path.join(root, "images", name), img)
    colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(sparse, "images.bin"))
    colmap.write_points3d_binary(points, colors,
                                 os.path.join(sparse, "points3D.bin"))


def make_colmap_scene(root, n_views=6, width=64, height=48, n_points=300,
                      seed=0, fov=0.9, device=DEFAULT_DEVICE):
    """Write sparse/0/*.bin + images/*.png rendered from gt gaussians."""
    from ..ops.rasterizer import RenderCamera, render

    gt = make_gt_gaussians(seed=seed, device=device)
    fx = graphics.fov2focal(fov, width)
    fy = graphics.fov2focal(fov, height)
    views = []
    for i in range(n_views):
        R_c2w, T = orbit_pose(2 * np.pi * i / n_views * 0.2 - 0.3)
        cam = cameras.make_camera(i, R_c2w, T,
                                  fovx=graphics.focal2fov(fx, width),
                                  fovy=graphics.focal2fov(fy, height),
                                  width=width, height=height)
        with torch.no_grad():
            img = render(gt, RenderCamera.from_camera(cam, device),
                         torch.zeros(3), device=device).rgb
        views.append((f"view{i:02d}.png", R_c2w, T, img.cpu().numpy()))
    rng = np.random.default_rng(seed)
    pts = gt.xyz.cpu().numpy()[rng.integers(0, gt.capacity, n_points)]
    pts = pts + rng.normal(scale=0.02, size=pts.shape)
    _write_colmap(root, width, height, fx, fy, views, pts,
                  rng.random((n_points, 3)) * 255)
    return gt


def write_cube_obj(path, center=(0, 0, 0), half=0.5):
    """Blender-convention cube OBJ (loader flips (x,y,z)->(x,-z,y)); the
    same bytes as the JAX package's writer."""
    cx, cy, cz = center
    # world-space target corners: loader maps (x,y,z)obj -> (x,-z,y)
    # so write obj coords (x, z, -y) of desired world corners.
    corners = []
    for dx in (-half, half):
        for dy in (-half, half):
            for dz in (-half, half):
                wx, wy, wz = cx + dx, cy + dy, cz + dz
                corners.append((wx, wz, -wy))
    quads = [(1, 2, 4, 3), (5, 7, 8, 6), (1, 5, 6, 2),
             (3, 4, 8, 7), (1, 3, 7, 5), (2, 6, 8, 4)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# cube\n")
        for c in corners:
            f.write(f"v {c[0]} {c[1]} {c[2]}\n")
        for q in quads:
            f.write("f " + " ".join(f"{i}//1" for i in q) + "\n")


def make_big_scene(n: int, seed: int = 0, scale_lo: float = 0.0015,
                   scale_hi: float = 0.008, device=DEFAULT_DEVICE):
    """Reference-scale synthetic scene (1-6M gaussians): dense clustered
    foreground blobs + ground plane + far background shell, splats small
    enough that pairs/gaussian stays at ~2-4 at 1080p, like a densified
    Mip-360 capture."""
    rng = np.random.default_rng(seed)
    n_core = int(n * 0.55)
    n_plane = int(n * 0.25)
    n_shell = n - n_core - n_plane
    k = 40
    centers = rng.uniform(-1.2, 1.2, (k, 3)) * np.array([1, 1, 0.6])
    idx = rng.integers(0, k, n_core)
    core = centers[idx] + rng.normal(0, 0.25, (n_core, 3))
    plane = np.stack([rng.uniform(-3, 3, n_plane),
                      rng.uniform(-1.6, -1.4, n_plane),
                      rng.uniform(-3, 3, n_plane)], -1)
    r = rng.uniform(4.0, 6.0, n_shell)
    theta = rng.uniform(0, 2 * np.pi, n_shell)
    phi = np.arccos(rng.uniform(-1, 1, n_shell))
    shell = np.stack([r * np.sin(phi) * np.cos(theta),
                      r * np.sin(phi) * np.sin(theta),
                      r * np.cos(phi)], -1)
    xyz = np.concatenate([core, plane, shell]).astype(np.float32)
    rgb = (np.tanh(xyz * 0.4) * 0.5 + 0.5).astype(np.float32)
    dc = sh_utils.rgb_to_sh(rgb).reshape(n, 1, 3)
    scales = rng.uniform(scale_lo, scale_hi, (n, 3)).astype(np.float32)
    scales[n_core + n_plane:] *= 4.0   # far shell: similar screen size
    op = rng.uniform(0.5, 0.95, (n, 1)).astype(np.float32)
    return gaussians.from_arrays(
        xyz, dc, np.zeros((n, 0, 3), np.float32), _logit32(op),
        np.log(scales), _identity_rots(n), device=device)


def with_sh_rest(params: gaussians.GaussianParams, degree: int = 3,
                 seed: int = 1, scale: float = 0.05):
    """``params`` with seeded SH rest coefficients up to ``degree``
    (``scale`` times a normal draw on the params' device), so that a
    projection at that degree has view-dependent colours to evaluate."""
    dev = params.xyz.device
    g = torch.Generator(device=dev).manual_seed(seed)
    m = (degree + 1) ** 2 - 1
    return dataclasses.replace(params, features_rest=scale * torch.randn(
        (params.capacity, m, 3), generator=g, device=dev))


def make_bench_ball(n: int = 100_000, seed: int = 0, capacity=None,
                    device=DEFAULT_DEVICE):
    """The repo bench's scene (``bench.py``, and the train-step bench's,
    ``scripts/bench_gs_train_step.py:51-69``): a ball of n splats, colour
    from position, opacity 0.8, scales in [0.004, 0.02], in a buffer of
    ``capacity`` rows."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    phi = np.arccos(rng.uniform(-1, 1, n))
    r = rng.uniform(0.3, 1.0, n) ** (1 / 3)
    xyz = np.stack([r * np.sin(phi) * np.cos(theta),
                    r * np.sin(phi) * np.sin(theta),
                    r * np.cos(phi)], -1).astype(np.float32)
    rgb = (xyz * 0.5 + 0.5).astype(np.float32)
    dc = sh_utils.rgb_to_sh(rgb).reshape(n, 1, 3)
    return gaussians.from_arrays(
        xyz, dc, np.zeros((n, 0, 3), np.float32),
        np.full((n, 1), float(_logit32(0.8))),
        np.log(rng.uniform(0.004, 0.02, (n, 3)).astype(np.float32)),
        _identity_rots(n), capacity=capacity, device=device)


def _yaw_pose(yaw: float):
    """(R_c2w, T) of the bench pose turned by ``yaw`` about world y: the
    camera orbits the origin at distance 3, looking at it."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return R, np.array([0.0, 0.0, 3.0])


def bench_camera(yaw: float = 0.0, uid: int = 0, image_name: str = ""):
    """The bench's 1920x1080 camera (fovx 1.1, fovy 0.7; R = I and
    T = (0, 0, 3) in COLMAP convention at yaw 0)."""
    R, T = _yaw_pose(yaw)
    return cameras.make_camera(uid, R, T, fovx=BENCH_FOVX, fovy=BENCH_FOVY,
                               width=BENCH_WIDTH, height=BENCH_HEIGHT,
                               image_name=image_name)


def write_orbit_colmap_scene(root, params, yaws, width, height,
                             n_points, seed=0):
    """A COLMAP scene to train on: PINHOLE cameras at the bench pose
    turned by each of ``yaws`` (bench fov), the images ``params``
    rendered there (on their device), and a point cloud of ``n_points``
    of their centres with 1 cm of jitter and their colours. Returns the
    image names in load order."""
    from ..ops.rasterizer import RenderCamera, render

    dev = params.xyz.device
    fx = graphics.fov2focal(BENCH_FOVX, width)
    fy = graphics.fov2focal(BENCH_FOVY, height)
    views = []
    for i, yaw in enumerate(yaws):
        R, T = _yaw_pose(yaw)
        cam = cameras.make_camera(i, R, T, fovx=graphics.focal2fov(fx, width),
                                  fovy=graphics.focal2fov(fy, height),
                                  width=width, height=height)
        with torch.no_grad():
            img = render(params, RenderCamera.from_camera(cam, dev),
                         torch.zeros(3), device=dev).rgb
        views.append((f"view{i:02d}.png", R, T,
                      torch.clamp(img, 0, 1).cpu().numpy()))
    rng = np.random.default_rng(seed)
    idx = rng.choice(int(params.live.sum()), n_points, replace=False)
    pts = params.xyz[idx].cpu().numpy() + rng.normal(
        scale=0.01, size=(n_points, 3))
    rgb = params.features_dc[idx, 0].cpu().numpy() * sh_utils.C0 + 0.5
    _write_colmap(root, width, height, fx, fy, views, pts,
                  np.clip(rgb, 0, 1) * 255)
    return [v[0] for v in views]


def write_gs_tree(root, scene="scene_case", ctrl="ctrl_0", modes=("x1",),
                  frames=14, size=(512, 384), iteration=30000, seed=0):
    """A synthetic gs/ hand-off tree for ``svd_test``, seeded PNGs at
    (H, W) = ``size``: ``ctrl1/<scene>/<ctrl>.png``, for each mode
    ``seq/<scene>/<mode>/ours_<iteration>/{renders,mask}/NN.png`` (smooth
    colour fields; a box mask drifting across the orbit) and
    ``depth/<scene>/<mode>/NN.png`` (a depth ramp as a grey image)."""
    h, w = size
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")

    def field(phase):
        c = rng.uniform(0.5, 3.0, (3, 2))
        img = [0.5 + 0.4 * np.sin(2 * np.pi * (c[i, 0] * xx + c[i, 1] * yy)
                                  + phase + i) for i in range(3)]
        return np.stack(img, -1).astype(np.float32)

    scene_io.save_image(os.path.join(root, "ctrl1", scene, f"{ctrl}.png"),
                        field(0.0))
    for mode in modes:
        seq = os.path.join(root, "seq", scene, mode, f"ours_{iteration}")
        for i in range(frames):
            v = f"{i:02d}"
            scene_io.save_image(os.path.join(seq, "renders", f"{v}.png"),
                                field(0.3 * i))
            mask = np.zeros((h, w), np.float32)
            x0 = int(w * (0.2 + 0.3 * i / max(frames - 1, 1)))
            mask[h // 4:h // 2 + h // 8, x0:x0 + w // 3] = 1.0
            scene_io.save_image(os.path.join(seq, "mask", f"{v}.png"), mask)
            depth = np.repeat((0.2 + 0.6 * yy + 0.1 * np.sin(
                6 * xx + i))[..., None], 3, -1).astype(np.float32)
            scene_io.save_image(os.path.join(root, "depth", scene, mode,
                                             f"{v}.png"), depth)


def write_est_tree(root, scenes=1, frames=14, size=(512, 384), warp=False,
                   seed=0):
    """A synthetic training tree for ``svd_train``: for each scene
    ``%09d/{rgb,est_depth,masks}/%05d.png`` at (H, W) = ``size`` (seeded
    noise images; a fixed box mask) and ``poses.npy`` (camera-to-world
    [frames, 4, 4], identity rotations on a slight zig-zag). With ``warp``
    also ``depth/%05d.png`` (uint16 millimetres, a flat 2 m) and
    ``metadata`` (JSON w, h and a column-major K), the
    ``WarpSVDForwardDataset`` contract."""
    import json

    from PIL import Image

    h, w = size
    for scene in range(scenes):
        d = os.path.join(root, f"{scene:09d}")
        for sub in ("rgb", "est_depth", "masks") + (("depth",) if warp
                                                    else ()):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        rng = np.random.default_rng(seed + scene)
        for i in range(frames):
            v = f"{i:05d}"
            for sub in ("rgb", "est_depth"):
                Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)
                                ).save(os.path.join(d, sub, f"{v}.png"))
            m = np.zeros((h, w), np.uint8)
            m[h // 4:h * 5 // 8, w // 4:w * 3 // 4] = 255
            Image.fromarray(m).save(os.path.join(d, "masks", f"{v}.png"))
            if warp:
                Image.fromarray(np.full((h, w), 2000, np.uint16)).save(
                    os.path.join(d, "depth", f"{v}.png"))
        poses = np.tile(np.eye(4, dtype=np.float32), (frames, 1, 1))
        poses[:, 0, 3] = 0.02 * np.arange(frames)
        poses[:, 1, 3] = 0.015 * (np.arange(frames) % 2)
        np.save(os.path.join(d, "poses.npy"), poses)
        if warp:
            K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1.0]])
            with open(os.path.join(d, "metadata"), "w") as f:
                json.dump({"w": w, "h": h, "K": list(K.T.reshape(-1))}, f)


def write_bench_colmap_scene(root, yaws=(0.0, -0.06, 0.06, 0.12),
                             n_points=1000, seed=0):
    """A COLMAP scene of bench cameras at the given yaws (1920x1080,
    PINHOLE) with black images and a random point cloud; returns the
    image names in load order."""
    black = np.zeros((BENCH_HEIGHT, BENCH_WIDTH, 3), np.float32)
    views = [(f"view{i:02d}.png", *_yaw_pose(yaw), black)
             for i, yaw in enumerate(yaws)]
    rng = np.random.default_rng(seed)
    _write_colmap(root, BENCH_WIDTH, BENCH_HEIGHT,
                  graphics.fov2focal(BENCH_FOVX, BENCH_WIDTH),
                  graphics.fov2focal(BENCH_FOVY, BENCH_HEIGHT), views,
                  rng.uniform(-1, 1, (n_points, 3)),
                  rng.random((n_points, 3)) * 255)
    return [v[0] for v in views]
