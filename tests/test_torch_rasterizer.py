"""Port parity, rasterizer: projection, binning, the plain versions of the
pair-key kernel (K1), the composite kernel (K2) and its backward (K3),
and ``render`` with its gradients.

Inputs come from numpy seeds and go through the JAX package (the
reference: ``render(backend="xla")`` and the XLA binning path; the Pallas
expansion and backward kernels only in interpret mode, in a clean
subprocess) and through its PyTorch port on the CPU. Tolerances:
projection at the bar of ``test_projection_matches_ewa_oracle``; images
rgb/alpha 3e-5 and depth 3e-4 (f32 exp/log1p and sums taken in another
order); integer outputs of binning exactly, on identical projected
inputs; gradients at 2e-6 + 1e-4 max|g| (the bar of
``tests/test_rasterizer.py:308-330``).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_inpaint_tpu.gs import cameras as jcameras
from multiview_inpaint_tpu.gs import gaussians as jgaussians
from multiview_inpaint_tpu.ops import rasterizer as jr
from multiview_inpaint_tpu.ops.rasterizer import binning as jbinning
from multiview_inpaint_tpu.ops.rasterizer import composite as jcomposite
from multiview_inpaint_tpu.ops.rasterizer import geometry as jgeometry
from multiview_inpaint_tpu.utils import sh as jsh
from multiview_inpaint_tpu.utils.schedules import inverse_sigmoid
from multiview_inpaint_tpu_torch.gs import gaussians as tgaussians
from multiview_inpaint_tpu_torch.ops import rasterizer as tr
from multiview_inpaint_tpu_torch.ops.rasterizer import binning as tbinning
from multiview_inpaint_tpu_torch.ops.rasterizer import composite as tcomposite
from multiview_inpaint_tpu_torch.ops.rasterizer import composite_cuda
from multiview_inpaint_tpu_torch.ops.rasterizer import geometry as tgeometry
from multiview_inpaint_tpu_torch.ops.rasterizer import pair_expand

RGB_TOL, DEPTH_TOL = 3e-5, 3e-4
BG = [0.1, 0.2, 0.3]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(n=300, seed=0, deg=0, capacity=None, xy=1.5, z=(-1.0, 3.0),
           scale=(0.02, 0.15), op=(0.2, 0.95), rotate=True):
    """A random JAX scene (the reference's test scenes, with random
    rotations and SH)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-xy, xy, size=(n, 3))
    xyz[:, 2] = rng.uniform(*z, size=n)
    rgb = rng.random((n, 3))
    dc = np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))).reshape(n, 1, 3)
    m = (deg + 1) ** 2 - 1
    rot = (rng.normal(size=(n, 4)) if rotate
           else np.tile([1.0, 0, 0, 0], (n, 1)))
    return jgaussians.from_arrays(
        xyz.astype(np.float32), dc.astype(np.float32),
        (rng.normal(size=(n, m, 3)) * 0.3).astype(np.float32),
        np.asarray(inverse_sigmoid(jnp.asarray(
            rng.uniform(*op, size=(n, 1))))).reshape(n, 1),
        np.log(rng.uniform(*scale, size=(n, 3))).astype(np.float32),
        rot.astype(np.float32), capacity=capacity)


def _port(jp):
    return tgaussians.params_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in tgaussians.FIELDS}, "cpu")


def _camera(width=80, height=64, z=4.0):
    return jcameras.make_camera(0, np.eye(3), np.array([0.0, 0, z]),
                                fovx=0.8, fovy=0.7, width=width,
                                height=height)


def _jax_render(jp, cam, tile=(16, 16), **kw):
    return jr.render(jp, jr.RenderCamera.from_camera(cam),
                     jnp.asarray(BG, jnp.float32), max_per_tile=1024,
                     pair_budget=64 * jp.capacity, tile=tile, **kw)


def _jax_project(jp, cam, sh_degree=0):
    rc = jr.RenderCamera.from_camera(cam)
    return jgeometry.project_gaussians(
        jp.xyz, jp.features(), jp.act_opacity()[:, 0], jp.act_scaling(),
        jp.act_rotation(), jp.live, rc.world_view, rc.full_proj, rc.campos,
        rc.tan_fovx, rc.tan_fovy, rc.width, rc.height, sh_degree)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_projection_matches_jax():
    jp = _scene(200, seed=1, deg=3, capacity=240)
    # behind the camera, at the frustum edge and non-finite rows
    xyz = np.array(jp.xyz)
    xyz[0] = [0.0, 0.0, -6.0]
    xyz[1] = [40.0, 0.0, 1.0]
    xyz[2] = [np.nan, 0.0, 1.0]
    jp = jgaussians.GaussianParams(**{**vars(jp), "xyz": jnp.asarray(xyz)})
    tp = _port(jp)
    cam = _camera()
    want = _jax_project(jp, cam, sh_degree=3)
    rc = tr.RenderCamera.from_camera(cam, "cpu")
    got = tgeometry.project_gaussians(
        tp.xyz, tp.features(), tp.act_opacity()[:, 0], tp.act_scaling(),
        tp.act_rotation(), tp.live, rc.world_view, rc.full_proj, rc.campos,
        rc.tan_fovx, rc.tan_fovy, rc.width, rc.height, 3)
    for f in ("means2d", "conic", "depth", "color", "opacity", "extent"):
        a = np.asarray(getattr(want, f))
        b = getattr(got, f).numpy()
        finite = np.isfinite(a)
        np.testing.assert_array_equal(np.isfinite(b), finite, err_msg=f)
        np.testing.assert_allclose(b[finite], a[finite], rtol=5e-3,
                                   atol=5e-4, err_msg=f)
    np.testing.assert_array_equal(got.radius.numpy(),
                                  np.asarray(want.radius))
    assert not got.radius[[0, 2]].any() and not got.radius[200:].any()


def _identical_projection(n, seed, cam, **scene_kw):
    """The JAX projection of a random scene, as numpy (fed to both
    packages' binning)."""
    proj = _jax_project(_scene(n, seed=seed, **scene_kw), cam)
    return {f: np.asarray(getattr(proj, f)) for f in proj._fields}


@pytest.mark.parametrize("tile", [(16, 16), (8, 16)])
def test_binning_integer_exact_on_identical_inputs(tile):
    cam = _camera(width=72, height=56)
    p = _identical_projection(300, 2, cam)
    th, tw = tile
    tx, ty = -(-72 // tw), -(-56 // th)
    n = p["means2d"].shape[0]
    kw = dict(tiles_x=tx, tiles_y=ty, tile_w=tw, tile_h=th,
              pair_budget=64 * n, max_per_tile=1024,
              extent=jnp.asarray(p["extent"]))
    args = (jnp.asarray(p["means2d"]), jnp.asarray(p["radius"]),
            jnp.asarray(p["depth"]))
    seg = jbinning.bin_gaussians(*args, gather_ids=False, aligned_chunk=128,
                                 **kw)
    dense = jbinning.bin_gaussians(*args, **kw)
    got = tbinning.bin_gaussians(_t(p["means2d"]), _t(p["radius"]),
                                 _t(p["depth"]), tx, ty, tw, th,
                                 extent=_t(p["extent"]))
    total = int(seg.total_pairs)
    assert got.total_pairs == total == int(dense.total_pairs) > 0
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(seg.counts))
    np.testing.assert_array_equal(got.seg_start.numpy(),
                                  np.asarray(seg.seg_start))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(seg.order))
    np.testing.assert_array_equal(got.gid_sorted.numpy(),
                                  np.asarray(seg.gid_sorted)[:total])
    # per-tile original-id lists, as the XLA dense gather sees them
    ids = got.order[got.gid_sorted].numpy()
    d_ids, d_valid = np.asarray(dense.ids), np.asarray(dense.valid)
    for t in range(tx * ty):
        s, c = int(got.seg_start[t]), int(got.counts[t])
        np.testing.assert_array_equal(ids[s:s + c], d_ids[t][d_valid[t]])


def _compacted(p, tiles_x, tiles_y, tile=16):
    return tbinning.compact_rects(_t(p["means2d"]), _t(p["radius"]),
                                  _t(p["depth"]), tiles_x, tiles_y, tile,
                                  tile, _t(p["extent"]))


def test_plain_k1_matches_xla_expansion():
    cam = _camera(width=96, height=64)
    r = _compacted(_identical_projection(400, 3, cam), 6, 4)
    keys = pair_expand.expand_keys(r.starts, r.x0, r.y0, r.w, r.count,
                                   r.n_active, r.total, 6)
    assert keys.shape == (r.total,) and r.total > 400
    i32 = lambda t: jnp.asarray(t.numpy().astype(np.int32))  # noqa: E731
    gid, tile, invalid = jbinning._expand_slots(
        i32(r.starts), i32(r.x0), i32(r.y0), i32(r.w), r.total,
        r.starts.shape[0], 6, 24, r.total + 64)
    assert not np.asarray(invalid)[:r.total].any()
    np.testing.assert_array_equal((keys >> 32).numpy(),
                                  np.asarray(tile)[:r.total])
    np.testing.assert_array_equal((keys & 0xFFFFFFFF).numpy(),
                                  np.asarray(gid)[:r.total])


_PALLAS_EXPAND = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from multiview_inpaint_tpu.ops.rasterizer.pair_expand import expand_keys
    d = dict(np.load(sys.argv[1]))
    keys, _ = expand_keys(
        jnp.asarray(d["starts"]), jnp.asarray(d["x0"]), jnp.asarray(d["y0"]),
        jnp.asarray(d["w"]), jnp.asarray(d["active"]), int(d["total"]),
        int(d["n"]), int(d["gid_bits"]), int(d["tiles_x"]),
        int(d["budget"]), interpret=True)
    np.save(sys.argv[2], np.asarray(keys))
""")


def test_plain_k1_matches_pallas_expand_keys(tmp_path):
    """The TPU kernel itself, in interpret mode, in a clean subprocess
    (interpret-mode Pallas can crash a long-lived XLA:CPU process)."""
    cam = _camera(width=96, height=64)
    r = _compacted(_identical_projection(300, 4, cam), 6, 4)
    n = r.starts.shape[0]
    gid_bits = max(1, n.bit_length())
    inputs = str(tmp_path / "in.npz")
    out = str(tmp_path / "keys.npy")
    np.savez(inputs, starts=r.starts.numpy().astype(np.int32),
             x0=r.x0.numpy(), y0=r.y0.numpy(), w=r.w.numpy(),
             active=(r.count > 0).numpy(), total=r.total, n=n,
             gid_bits=gid_bits, tiles_x=6, budget=r.total + 256)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", _PALLAS_EXPAND, inputs,
                           out], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out).astype(np.int64)
    keys = pair_expand.expand_keys_ref(r.starts, r.x0, r.y0, r.w, r.count,
                                       r.n_active, r.total, 6).numpy()
    np.testing.assert_array_equal(keys >> 32, want[:r.total] >> gid_bits)
    np.testing.assert_array_equal(keys & 0xFFFFFFFF,
                                  want[:r.total] & ((1 << gid_bits) - 1))
    assert (want[r.total:] == 2 ** 31 - 1).all()


@pytest.mark.parametrize("tile", [(16, 16), (8, 16)])
def test_render_matches_jax_xla(tile):
    jp = _scene(300, seed=5, deg=1, capacity=320)
    cam = _camera(width=80, height=64)
    a = _jax_render(jp, cam, tile=tile, sh_degree=1)
    b = tr.render(_port(jp), tr.RenderCamera.from_camera(cam, "cpu"), BG,
                  sh_degree=1, tile=tile, device="cpu")
    assert b.pairs == int(a.pairs) > 0
    np.testing.assert_allclose(b.rgb.numpy(), np.asarray(a.rgb),
                               atol=RGB_TOL)
    np.testing.assert_allclose(b.depth.numpy(), np.asarray(a.depth),
                               atol=DEPTH_TOL)
    np.testing.assert_allclose(b.alpha.numpy(), np.asarray(a.alpha),
                               atol=RGB_TOL)
    np.testing.assert_array_equal(b.radii.numpy(), np.asarray(a.radii))
    np.testing.assert_array_equal(b.visibility.numpy(),
                                  np.asarray(a.visibility))


def test_plain_k2_deep_tile_chunk_stop_rule():
    """A tile with >128 splats saturates in its first chunk; the
    reference's chunk-scoped stop rule lets later chunks contribute
    again. The plain K2 must reproduce the XLA compositor on identical
    projected inputs, and the rule must matter on this scene."""
    cam = _camera(width=48, height=48)
    p = _identical_projection(400, 6, cam, xy=0.08, z=(0.0, 3.0),
                              scale=(0.03, 0.12), op=(0.05, 0.95))
    tile, tiles = 16, 3
    bins = tbinning.bin_gaussians(_t(p["means2d"]), _t(p["radius"]),
                                  _t(p["depth"]), tiles, tiles, tile, tile,
                                  extent=_t(p["extent"]))
    assert int(bins.counts.max()) > 2 * tcomposite.CHUNK
    attrs = composite_cuda.pack_attrs(
        _t(p["means2d"]), _t(p["conic"]), _t(p["opacity"]), _t(p["color"]),
        _t(p["depth"]))[bins.order[bins.gid_sorted]]
    raw = tcomposite.composite_segments(attrs, bins.seg_start, bins.counts,
                                        tiles, tiles, tile, tile)
    jb = jbinning.bin_gaussians(
        jnp.asarray(p["means2d"]), jnp.asarray(p["radius"]),
        jnp.asarray(p["depth"]), tiles, tiles, tile, tile, 64 * 400, 1024,
        extent=jnp.asarray(p["extent"]))
    want = jcomposite.composite_tiles(
        jb.ids, jb.valid, jr.api._tile_pixel_coords(tiles, tiles, tile,
                                                    tile),
        *(jnp.asarray(p[f]) for f in ("means2d", "conic", "color", "depth",
                                      "opacity")),
        jnp.asarray(BG, jnp.float32), chunk=128)
    bg = torch.tensor(BG)
    t_fin = raw[:, 4, :]
    np.testing.assert_allclose(
        (raw[:, 0:3, :].transpose(1, 2) + t_fin[..., None] * bg).numpy(),
        np.asarray(want.rgb), atol=RGB_TOL)
    np.testing.assert_allclose(
        (raw[:, 3, :] + t_fin * tcomposite.DEPTH_EMPTY).numpy(),
        np.asarray(want.depth), atol=DEPTH_TOL)
    np.testing.assert_allclose((1 - t_fin).numpy(), np.asarray(want.alpha),
                               atol=RGB_TOL)
    # One chunk over the whole segment stops each pixel for good.
    once = tcomposite.composite_segments(attrs, bins.seg_start, bins.counts,
                                         tiles, tiles, tile, tile,
                                         chunk=4096)
    assert (once[:, 0:4] - raw[:, 0:4]).abs().max() > 1e-6


def test_render_oracle_matches_jax():
    jp = _scene(120, seed=7)
    cam = _camera(width=40, height=32)
    a = jr.render_oracle(jp, jr.RenderCamera.from_camera(cam),
                         jnp.asarray(BG, jnp.float32))
    b = tr.render_oracle(_port(jp), tr.RenderCamera.from_camera(cam, "cpu"),
                         BG, device="cpu")
    np.testing.assert_allclose(b.rgb.numpy(), np.asarray(a.rgb),
                               atol=RGB_TOL)
    np.testing.assert_allclose(b.depth.numpy(), np.asarray(a.depth),
                               atol=DEPTH_TOL)
    t = tr.render(_port(jp), tr.RenderCamera.from_camera(cam, "cpu"), BG,
                  device="cpu")
    np.testing.assert_allclose(t.rgb.numpy(), b.rgb.numpy(), atol=RGB_TOL)


def _assert_grad_close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=2e-6 + 1e-4 * np.abs(want).max(),
                               err_msg=msg)


def _check_render_gradients(tile):
    """Whole-render gradients (through the port's plain K3 and the
    gather's backward) against JAX autodiff through the XLA path."""
    jp = _scene(120, seed=8)
    cam = _camera(width=48, height=32)
    target = np.random.default_rng(0).random((32, 48, 3)).astype(np.float32)

    def jloss(params, offset):
        out = _jax_render(params, cam, tile=tile, means2d_offset=offset)
        return (jnp.mean((out.rgb - target) ** 2)
                + 0.1 * jnp.mean(out.depth) + 0.05 * jnp.mean(out.alpha))

    g_params, g_off = jax.grad(jloss, argnums=(0, 1), allow_int=True)(
        jp, jnp.zeros((jp.capacity, 2)))
    tp = _port(jp)
    names = ("xyz", "features_dc", "opacity", "scaling", "rotation")
    for f in names:
        getattr(tp, f).requires_grad_(True)
    offset = torch.zeros((tp.capacity, 2), requires_grad=True)
    out = tr.render(tp, tr.RenderCamera.from_camera(cam, "cpu"), BG,
                    means2d_offset=offset, tile=tile, device="cpu")
    loss = ((out.rgb - torch.from_numpy(target)) ** 2).mean() \
        + 0.1 * out.depth.mean() + 0.05 * out.alpha.mean()
    loss.backward()
    for f, want in [(f, np.asarray(getattr(g_params, f))) for f in names] \
            + [("means2d_offset", np.asarray(g_off))]:
        got = (offset if f == "means2d_offset" else getattr(tp, f)).grad
        _assert_grad_close(got.numpy(), want, f)


def test_cpu_render_gradients_match_jax():
    _check_render_gradients((16, 16))


def test_cpu_render_gradients_match_jax_8x16_tiles():
    _check_render_gradients((8, 16))


def _pair_inputs(p, width, height, tile):
    """Bins and pair-sorted packed attrs of identical projected inputs."""
    th, tw = tile
    tx, ty = -(-width // tw), -(-height // th)
    bins = tbinning.bin_gaussians(_t(p["means2d"]), _t(p["radius"]),
                                  _t(p["depth"]), tx, ty, tw, th,
                                  extent=_t(p["extent"]))
    attrs = composite_cuda.pack_attrs(
        _t(p["means2d"]), _t(p["conic"]), _t(p["opacity"]), _t(p["color"]),
        _t(p["depth"]))[bins.order[bins.gid_sorted]].contiguous()
    return bins, attrs, (tx, ty, th, tw)


def _cotangent(shape, seed):
    """A random cotangent on the raw rows 0-4 (rows 5-7 are padding)."""
    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    g[:, 5:] = 0.0
    return torch.from_numpy(g)


@pytest.mark.parametrize("case", ["16x16", "8x16", "deep_tile"])
def test_plain_k3_matches_autograd_through_plain_k2(case):
    """Plain K3 against autograd through the plain K2 on the same pairs.
    ``deep_tile``: a tile of > 2 chunks whose pixels saturate, so the
    chunk-scoped stop rule fires."""
    if case == "deep_tile":
        cam = _camera(width=48, height=48)
        p = _identical_projection(400, 6, cam, xy=0.08, z=(0.0, 3.0),
                                  scale=(0.03, 0.12), op=(0.05, 0.95))
        bins, attrs, size = _pair_inputs(p, 48, 48, (16, 16))
        assert int(bins.counts.max()) > 2 * tcomposite.CHUNK
    else:
        cam = _camera(width=80, height=64)
        p = _identical_projection(300, 10, cam)
        tile = (16, 16) if case == "16x16" else (8, 16)
        bins, attrs, size = _pair_inputs(p, 80, 64, tile)
    leaf = attrs.clone().requires_grad_(True)
    raw = tcomposite.composite_segments(leaf, bins.seg_start, bins.counts,
                                        *size)
    if case == "deep_tile":
        # The stop rule matters here: one chunk over the whole segment
        # (a permanent stop) gives another image.
        once = tcomposite.composite_segments(attrs, bins.seg_start,
                                             bins.counts, *size, chunk=4096)
        assert (once[:, 0:4] - raw.detach()[:, 0:4]).abs().max() > 1e-6
    g = _cotangent(raw.shape, 1)
    (raw * g).sum().backward()
    got = tcomposite.composite_segments_bwd(attrs, bins.seg_start,
                                            bins.counts, raw.detach(), g,
                                            *size)
    want = leaf.grad.numpy()
    assert got.shape == attrs.shape
    for r in range(10):
        _assert_grad_close(got[:, r].numpy(), want[:, r], f"row {r}")
    assert (got[:, 10:] == 0).all() and (want[:, 10:] == 0).all()


_PALLAS_BWD = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from multiview_inpaint_tpu.ops.rasterizer.pallas_backward import (
        composite_pallas_bwd)
    d = dict(np.load(sys.argv[1]))
    g = composite_pallas_bwd(
        jnp.asarray(d["attrs_t"]), jnp.asarray(d["seg_start"]),
        jnp.asarray(d["counts"]), jnp.zeros((3,), jnp.float32),
        jnp.asarray(d["tiles8"]), jnp.asarray(d["g_tiles8"]),
        int(d["tiles_x"]), int(d["tiles_y"]), int(d["tile_h"]),
        int(d["tile_w"]), interpret=True)
    np.save(sys.argv[2], np.asarray(g))
""")


def test_plain_k3_matches_pallas_bwd_kernel(tmp_path):
    """The TPU kernel itself (``pallas_backward._bwd_kernel``), in
    interpret mode, in a clean subprocess, pair by pair. The scene is
    shallow (no pixel reaches T < 1e-3), because the JAX kernel anchors
    its chunks at 128-aligned windows and the port at segment starts;
    the two walks agree wherever the stop rule does not fire."""
    cam = _camera(width=64, height=48)
    p = _identical_projection(160, 11, cam, op=(0.05, 0.5))
    bins, attrs, size = _pair_inputs(p, 64, 48, (16, 16))
    raw = tcomposite.composite_segments(attrs, bins.seg_start, bins.counts,
                                        *size)
    assert float(raw[:, 4].min()) > 1e-3 and bins.total_pairs > 256
    g = _cotangent(raw.shape, 2)
    n_pairs = bins.total_pairs
    p_aligned = -(-n_pairs // 128) * 128 + 128   # room for the last window
    attrs_t = np.zeros((tcomposite.NROWS, p_aligned), np.float32)
    attrs_t[:, :n_pairs] = attrs.numpy().T
    inputs = str(tmp_path / "in.npz")
    out = str(tmp_path / "grads.npy")
    tx, ty, th, tw = size
    np.savez(inputs, attrs_t=attrs_t,
             seg_start=bins.seg_start.numpy().astype(np.int32),
             counts=bins.counts.numpy().astype(np.int32),
             tiles8=raw.numpy(), g_tiles8=g.numpy(), tiles_x=tx, tiles_y=ty,
             tile_h=th, tile_w=tw)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, "-c", _PALLAS_BWD, inputs, out],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out).T[:n_pairs]
    got = tcomposite.composite_segments_bwd(attrs, bins.seg_start,
                                            bins.counts, raw, g,
                                            *size).numpy()
    for r in range(10):
        _assert_grad_close(got[:, r], want[:, r], f"row {r}")
    assert (want[:, 10:] == 0).all() and (got[:, 10:] == 0).all()


def test_render_views_and_empty_frame():
    jp = _scene(60, seed=9, capacity=64)
    tp = _port(jp)
    cams = [jcameras.make_camera(i, np.eye(3),
                                 np.array([0.1 * i, 0.0, 4.0 + 0.2 * i]),
                                 fovx=0.8, fovy=0.8, width=48, height=32)
            for i in range(3)]
    outs = tr.render_views(tp, cams, BG, device="cpu")
    assert outs.rgb.shape == (3, 32, 48, 3)
    for i, c in enumerate(cams):
        one = tr.render(tp, tr.RenderCamera.from_camera(c, "cpu"), BG,
                        device="cpu")
        assert torch.equal(outs.rgb[i], one.rgb) and outs.pairs[i] == \
            one.pairs
    # Every gaussian behind the camera: zero pairs, background only.
    back = _camera(width=48, height=32, z=-10.0)
    a = _jax_render(jp, back)
    b = tr.render(tp, tr.RenderCamera.from_camera(back, "cpu"), BG,
                  device="cpu")
    assert b.pairs == int(a.pairs) == 0
    assert torch.equal(b.rgb, torch.tensor(BG).expand(32, 48, 3))
    assert (b.depth == tcomposite.DEPTH_EMPTY).all() and (b.alpha == 0).all()
    np.testing.assert_array_equal(b.rgb.numpy(), np.asarray(a.rgb))


def test_wrappers_take_cpu_or_cuda_only():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pair_expand.expand_keys(
            torch.zeros(4, dtype=torch.int64, **meta),
            *(torch.zeros(4, dtype=torch.int32, **meta),) * 3,
            torch.zeros(4, dtype=torch.int64, **meta), 4, 4, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        composite_cuda.composite(
            torch.zeros((8, 16), **meta),
            *(torch.zeros(4, dtype=torch.int64, **meta),) * 2, 2, 2, 16, 16)
