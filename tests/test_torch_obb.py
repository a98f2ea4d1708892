"""Port parity, stage-1 geometry: the OBB, the orbit and SDS cameras, the
quaternion and SH helpers and the stage-1 CLI plumbing, against the JAX
package (no rendering).

Tolerances:
- ``write_cube_obj``, ``load_obb``, ``from_center_axes``, the orbit
  cameras (``camera_to_world``, fov, size, names), ``sds_cameras``' names,
  order, images and masks: exactly equal (numpy copies of the JAX code).
- ``intersect`` on 10,000 seeded rays (outside, inside, axis-parallel,
  grazing, zero-direction) against the JAX function: ``hit`` equal except
  on rays whose float64 barycentrics lie within 1e-6 of a triangle edge
  or whose origin lies within 1e-6 of a face (``obb.fragile_rays``), and
  such rays are at most 0.1% of all; ``t`` and the hit points within
  1e-5 max(1, |t|) where both hit; 0 where neither does. Chunked and
  unchunked port results are bit-equal.
- ``contains`` on seeded points, a quarter of them within 1e-3 of a
  face: equal except points whose +-x rays are fragile as above.
- ``sample_uniform`` fed JAX's uniforms: within 1e-6, every point inside.
- ``scaling_rotation``, ``covariance_from_scaling_rotation``,
  ``strip_symmetric`` and ``sh_to_rgb``: within 1e-6.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_inpaint_tpu.config import registries as jreg
from multiview_inpaint_tpu.gs import cameras as jcameras
from multiview_inpaint_tpu.gs import obb as jobb
from multiview_inpaint_tpu.gs import scene as jscene
from multiview_inpaint_tpu.pipelines import common as jcommon
from multiview_inpaint_tpu.utils import quaternion as jquat
from multiview_inpaint_tpu.utils import sh as jsh
from multiview_inpaint_tpu.utils import synthetic as jsynthetic
from multiview_inpaint_tpu_torch.config import registries as treg
from multiview_inpaint_tpu_torch.gs import cameras as tcameras
from multiview_inpaint_tpu_torch.gs import obb as tobb
from multiview_inpaint_tpu_torch.gs import scene as tscene
from multiview_inpaint_tpu_torch.gs import scene_io
from multiview_inpaint_tpu_torch.pipelines import common as tcommon
from multiview_inpaint_tpu_torch.utils import quaternion as tquat
from multiview_inpaint_tpu_torch.utils import sh as tsh
from multiview_inpaint_tpu_torch.utils import synthetic as tsynthetic

FIELDS = ("vertices", "faces", "face_verts", "axes", "origin", "center")
FRAGILE_SHARE, T_TOL = 1e-3, 1e-5
REGISTRY_DICTS = ("FRONT_VIEWS", "INSERTION_PROMPTS", "ORBIT_PARAMS",
                  "VIS_PARAMS")


def _rotation(seed):
    q = np.random.default_rng(seed).normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)]])


def _write_rotated_cube(path, center, half, rot):
    """A cube OBJ in ``write_cube_obj``'s vertex and face layout, its
    corners turned by ``rot`` about ``center``."""
    corners = []
    for dx in (-half[0], half[0]):
        for dy in (-half[1], half[1]):
            for dz in (-half[2], half[2]):
                w = np.asarray(center) + rot @ np.array([dx, dy, dz])
                corners.append((w[0], w[2], -w[1]))
    quads = [(1, 2, 4, 3), (5, 7, 8, 6), (1, 5, 6, 2),
             (3, 4, 8, 7), (1, 3, 7, 5), (2, 6, 8, 4)]
    with open(path, "w") as f:
        for c in corners:
            f.write(f"v {float(c[0])!r} {float(c[1])!r} {float(c[2])!r}\n")
        for q in quads:
            f.write("f " + " ".join(f"{i}//1" for i in q) + "\n")


@pytest.fixture(scope="module")
def boxes(tmp_path_factory):
    root = tmp_path_factory.mktemp("boxes")
    aligned = str(root / "aligned.obj")
    rotated = str(root / "rotated.obj")
    tsynthetic.write_cube_obj(aligned, center=(0.2, 0.1, 0.0), half=0.3)
    _write_rotated_cube(rotated, (-0.1, 0.25, 0.3), (0.4, 0.25, 0.15),
                        _rotation(3))
    return {"aligned": aligned, "rotated": rotated}


@pytest.fixture
def restore_registries():
    saved = [(mod, name, dict(getattr(mod, name)))
             for mod in (jreg, treg) for name in REGISTRY_DICTS]
    yield
    for mod, name, d in saved:
        getattr(mod, name).clear()
        getattr(mod, name).update(d)


@pytest.mark.parametrize("center,half", [((0, 0, 0), 0.5),
                                         ((0.2, 0.1, 0), 0.3),
                                         ((-1.25, 0.7, 2.1), 0.123),
                                         ((0.1, -0.2, 0.3), 1)])
def test_write_cube_obj_bytes(tmp_path, center, half):
    a, b = str(tmp_path / "jax.obj"), str(tmp_path / "port.obj")
    jsynthetic.write_cube_obj(a, center=center, half=half)
    tsynthetic.write_cube_obj(b, center=center, half=half)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("name", ["aligned", "rotated"])
def test_load_obb_matches_jax(boxes, name):
    j, t = jobb.load_obb(boxes[name]), tobb.load_obb(boxes[name])
    for f in FIELDS:
        assert getattr(j, f).dtype == getattr(t, f).dtype, f
        np.testing.assert_array_equal(getattr(j, f), getattr(t, f), f)
    # origin + sum u_i axes_i spans the box: the corners are its vertices
    u = np.array([[a, b, c] for a in (0, 1) for b in (0, 1)
                  for c in (0, 1)], np.float32)
    corners = t.origin + u @ t.axes
    dist = np.abs(corners[:, None] - t.vertices[None]).max(-1).min(-1)
    assert dist.max() < 1e-6
    np.testing.assert_allclose(t.center, t.vertices.mean(0), atol=1e-6)


def test_from_center_axes_matches_jax():
    center = np.array([0.3, -0.2, 0.5], np.float32)
    axes = (_rotation(5) * np.array([0.6, 0.4, 0.2])).T.astype(np.float32)
    j, t = (jobb.from_center_axes(center, axes),
            tobb.from_center_axes(center, axes))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(j, f), getattr(t, f), f)


def _rays(box, seed, n=10_000):
    """Seeded rays of five kinds around ``box``: 40% from outside toward
    it, 20% from inside, 20% axis-parallel, 15% grazing an edge (aimed
    1e-4 to 1e-3 off it, 3 at the edge itself), 5% zero."""
    rng = np.random.default_rng(seed)
    c = box.center.astype(np.float64)
    ext = np.linalg.norm(box.axes, axis=1).max()
    n_out, n_in, n_ax, n_gr = (int(n * s) for s in (0.4, 0.2, 0.2, 0.15))
    n_zero = n - n_out - n_in - n_ax - n_gr

    def unit(k):
        v = rng.normal(size=(k, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    o_out = c + unit(n_out) * rng.uniform(2, 4, (n_out, 1))
    d_out = c + rng.normal(scale=0.6 * ext, size=(n_out, 3)) - o_out
    o_in = box.origin + rng.uniform(0.02, 0.98, (n_in, 3)) @ box.axes
    d_in = unit(n_in) * rng.uniform(0.5, 2, (n_in, 1))
    o_ax = c + rng.uniform(-1.5, 1.5, (n_ax, 3)) * ext
    d_ax = np.zeros((n_ax, 3))
    d_ax[np.arange(n_ax), rng.integers(0, 3, n_ax)] = rng.choice([-1, 1],
                                                               n_ax)
    edges = [(i, j) for i in range(8) for j in range(i + 1, 8)
             if np.isclose(np.linalg.norm(box.vertices[i] - box.vertices[j]),
                           np.linalg.norm(box.axes, axis=1)).any()]
    pick = rng.integers(0, len(edges), n_gr)
    lam = rng.uniform(0.05, 0.95, (n_gr, 1))
    a = box.vertices[[edges[k][0] for k in pick]].astype(np.float64)
    b = box.vertices[[edges[k][1] for k in pick]].astype(np.float64)
    off = unit(n_gr) * 10 ** rng.uniform(-4, -3, (n_gr, 1))
    off[:3] = 0.0
    target = a + lam * (b - a) + off
    d_gr = unit(n_gr)
    o_gr = target - d_gr * rng.uniform(1, 3, (n_gr, 1))
    o_zero = c + unit(n_zero)
    rayo = np.concatenate([o_out, o_in, o_ax, o_gr, o_zero])
    rayd = np.concatenate([d_out, d_in, d_ax, d_gr, np.zeros((n_zero, 3))])
    return rayo.astype(np.float32), rayd.astype(np.float32)


@pytest.mark.parametrize("name", ["aligned", "rotated"])
def test_intersect_matches_jax(boxes, name, monkeypatch):
    box = tobb.load_obb(boxes[name])
    rayo, rayd = _rays(box, seed=11)
    pj, tj, hj = (np.asarray(x) for x in jobb.intersect(
        jobb.load_obb(boxes[name]), jnp.asarray(rayo), jnp.asarray(rayd)))
    o, d = torch.from_numpy(rayo), torch.from_numpy(rayd)
    pt, tt, ht = tobb.intersect(box, o, d)
    monkeypatch.setattr(tobb, "RAY_CHUNK", 777)
    pc, tc, hc = tobb.intersect(box, o, d)
    assert (torch.equal(pt, pc) and torch.equal(tt, tc)
            and torch.equal(ht, hc))
    pt, tt, ht = pt.numpy(), tt.numpy(), ht.numpy()
    assert np.isfinite(pt).all() and np.isfinite(tt).all()

    fragile = tobb.fragile_rays(box, rayo, rayd)
    differ = hj != ht
    print(f"{name}: {int(hj.sum())} hits of {len(hj)} rays, "
          f"{int(fragile.sum())} fragile, {int(differ.sum())} differ")
    assert not (differ & ~fragile).any()
    assert tobb.FRAGILE_TOL == 1e-6 and fragile.mean() <= FRAGILE_SHARE
    assert 0.2 < hj.mean() < 0.8
    both = hj & ht
    bar = T_TOL * np.maximum(1.0, np.abs(tj[both]))
    assert (np.abs(tj[both] - tt[both]) <= bar).all()
    assert (np.abs(pj[both] - pt[both]).max(-1) <= bar).all()
    neither = ~hj & ~ht
    assert (tt[neither] == 0).all() and (pt[neither] == 0).all()
    zero = np.linalg.norm(rayd, axis=1) == 0
    assert zero.sum() == 500 and not ht[zero].any()


@pytest.mark.parametrize("name", ["aligned", "rotated"])
def test_contains_matches_jax(boxes, name):
    box = tobb.load_obb(boxes[name])
    rng = np.random.default_rng(7)
    n_free, n_face = 6000, 2000
    u_free = rng.uniform(-0.25, 1.25, (n_free, 3))
    u_face = rng.uniform(0, 1, (n_face, 3))
    axis = rng.integers(0, 3, n_face)
    lens = np.linalg.norm(box.axes, axis=1)
    u_face[np.arange(n_face), axis] = (
        rng.integers(0, 2, n_face)
        + rng.uniform(-1e-3, 1e-3, n_face) / lens[axis])
    pts = (box.origin + np.concatenate([u_free, u_face]) @ box.axes
           ).astype(np.float32)
    cj = np.asarray(jobb.contains(jobb.load_obb(boxes[name]),
                                  jnp.asarray(pts)))
    ct = tobb.contains(box, torch.from_numpy(pts)).numpy()
    dx = np.zeros_like(pts)
    dx[:, 0] = 1.0
    fragile = (tobb.fragile_rays(box, pts, dx)
               | tobb.fragile_rays(box, pts, -dx))
    differ = cj != ct
    print(f"{name}: {int(cj.sum())} of {len(pts)} inside, "
          f"{int(fragile.sum())} within 1e-6 of a face, "
          f"{int(differ.sum())} differ")
    assert not (differ & ~fragile).any()
    assert 0.1 < ct.mean() < 0.9


def test_sample_uniform_matches_jax(boxes):
    jbox, box = (jobb.load_obb(boxes["rotated"]),
                 tobb.load_obb(boxes["rotated"]))
    key = jax.random.key(4)
    want = np.asarray(jobb.sample_uniform(jbox, key, 1000))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (1000, 3))))
    got = tobb.sample_uniform(box, None, 1000, u=u)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert tobb.contains(box, got).all()
    drawn = tobb.sample_uniform(box, torch.Generator().manual_seed(0), 500)
    assert drawn.shape == (500, 3) and tobb.contains(box, drawn).all()


def _front_camera(cameras):
    R = _rotation(9)
    return cameras.make_camera(0, R, np.array([0.1, -0.2, 3.0]), fovx=0.9,
                               fovy=0.7, width=96, height=64,
                               image_name="front")


@pytest.mark.parametrize("mode", ["x1", "x2", "y1", "y2"])
def test_orbit_cameras_match_jax(boxes, mode):
    kw = dict(mode=mode, frames=5, view_range=np.pi / 4, r_scale=0.8,
              k_lift=np.pi / 9, k_bias=np.pi / 12, new_size=(320, 240))
    js = jscene.orbit_cameras(_front_camera(jcameras),
                              jobb.load_obb(boxes["rotated"]), **kw)
    ts = tscene.orbit_cameras(_front_camera(tcameras),
                              tobb.load_obb(boxes["rotated"]), **kw)
    assert [c.image_name for c in ts] == [c.image_name for c in js] == [
        f"{i:02d}" for i in range(5)]
    for j, t in zip(js, ts):
        assert (t.width, t.height) == (j.width, j.height) == (240, 320)
        assert (t.fovx, t.fovy) == (j.fovx, j.fovy)
        np.testing.assert_array_equal(t.camera_to_world, j.camera_to_world)


def test_orbit_cameras_unknown_mode_raises(boxes):
    with pytest.raises(ValueError, match="unknown orbit mode"):
        tscene.orbit_cameras(_front_camera(tcameras),
                             tobb.load_obb(boxes["aligned"]), mode="z1")


def test_sds_cameras_match_jax(tmp_path, boxes):
    src = str(tmp_path / "scene")
    tsynthetic.make_colmap_scene(src, n_views=3, device="cpu")
    ws_root, iteration = str(tmp_path / "ws"), 30000
    tws = tscene.Workspace(ws_root)
    seq = tws.seq_dir("toy_case", "x1", iteration)
    os.makedirs(seq)
    rng = np.random.default_rng(2)
    scenes = {}
    for name, mod in (("jax", jscene), ("port", tscene)):
        scenes[name] = mod.Scene(src, str(tmp_path / "model" / "toy"),
                                 resolution=1, shuffle=False,
                                 load_gaussians=False,
                                 workspace=mod.Workspace(ws_root))
        scenes[name].scene_name = "toy_case"
    cams = scenes["port"].train_cameras()
    np.save(os.path.join(seq, "poses.npy"),
            np.stack([c.camera_to_world for c in cams]).astype(np.float32))
    bt = tws.seq_dir("toy_case", "bds_train", iteration)
    for i, cam in enumerate(cams):
        scene_io.save_image(os.path.join(bt, "renders",
                                         f"{cam.image_name}.png"),
                            rng.random((48, 64, 3)))
        mask = (rng.random((48, 64)) > 0.7).astype(np.float32)
        scene_io.save_image(os.path.join(bt, "mask",
                                         f"{cam.image_name}.png"),
                            mask * (i != 1))   # view01's mask is empty
    box = boxes["aligned"]
    for kw in (dict(seed=3), dict(shuffle=False),
               dict(view_range=0.05, shuffle=False)):
        j = jscene.sds_cameras(scenes["jax"], jobb.load_obb(box), **kw)
        t = tscene.sds_cameras(scenes["port"], tobb.load_obb(box), **kw)
        assert [c.image_name for c in t] == [c.image_name for c in j]
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a.image, b.image)
            np.testing.assert_array_equal(a.mask, b.mask)
            np.testing.assert_array_equal(a.world_view, b.world_view)
        if kw.get("view_range") is None:
            assert sorted(c.image_name for c in t) == ["view00", "view02"]
        else:
            assert [c.image_name for c in t] == ["view00"]


def test_quaternion_and_sh_helpers_match_jax():
    rng = np.random.default_rng(5)
    scale = rng.uniform(0.01, 2.0, (64, 3)).astype(np.float32)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    ts, tq = torch.from_numpy(scale), torch.from_numpy(q)
    pairs = [
        (jquat.scaling_rotation(jnp.asarray(scale), jnp.asarray(q)),
         tquat.scaling_rotation(ts, tq)),
        (jquat.covariance_from_scaling_rotation(jnp.asarray(scale),
                                                jnp.asarray(q), 0.7),
         tquat.covariance_from_scaling_rotation(ts, tq, 0.7)),
    ]
    cov = tquat.covariance_from_scaling_rotation(ts, tq)
    pairs.append((jquat.strip_symmetric(jnp.asarray(cov.numpy())),
                  tquat.strip_symmetric(cov)))
    sh = rng.normal(size=(64, 1, 3)).astype(np.float32)
    pairs.append((jsh.sh_to_rgb(jnp.asarray(sh)),
                  tsh.sh_to_rgb(torch.from_numpy(sh))))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(tsh.sh_to_rgb(tsh.rgb_to_sh(sh)), sh,
                               atol=1e-6)


def test_resolve_orbit(restore_registries):
    args = argparse.Namespace(scene_id="nosuchscene_case",
                              allow_default_orbit=False)
    with pytest.raises(KeyError, match="not in the orbit registry"):
        tcommon.resolve_orbit(args)
    args.allow_default_orbit = True
    with pytest.warns(UserWarning, match="default OrbitParams"):
        got = tcommon.resolve_orbit(args)
    assert got == treg.OrbitParams()
    args.scene_id = "bicycle_bear"
    assert tcommon.resolve_orbit(args) == treg.ORBIT_PARAMS["bicycle"]
    assert (tcommon.resolve_orbit(args, treg.VIS_PARAMS)
            == treg.VIS_PARAMS["bicycle"])


def test_apply_registry_and_model_args(tmp_path, restore_registries):
    path = str(tmp_path / "registry.json")
    with open(path, "w") as f:
        json.dump({"front_views": {"toy": "view01"},
                   "insertion_prompts": {"toy_cube": "a cube"},
                   "orbit_params": {"toy": {"k_lift": 0.3, "r_scale": 0.9}},
                   "vis_params": {"toy": {"view_range": 0.5}}}, f)
    tcommon.apply_registry(argparse.Namespace(registry=None))
    assert "toy" not in treg.FRONT_VIEWS
    for common in (jcommon, tcommon):
        common.apply_registry(argparse.Namespace(registry=path))
    for name in REGISTRY_DICTS:
        j, t = getattr(jreg, name), getattr(treg, name)
        assert ({k: str(v) for k, v in j.items()}
                == {k: str(v) for k, v in t.items()}), name
    assert treg.FRONT_VIEWS["toy"] == "view01"
    assert treg.ORBIT_PARAMS["toy"] == treg.OrbitParams(k_lift=0.3,
                                                        r_scale=0.9)
    args = tcommon.resolve_orbit(argparse.Namespace(scene_id="toy_cube"))
    assert args.r_scale == 0.9
    parsers = []
    for common in (jcommon, tcommon):
        p = argparse.ArgumentParser()
        common.add_model_args(p)
        common.add_registry_arg(p)
        common.add_orbit_args(p)
        parsers.append(p)
    argv = ["-s", "data/toy", "-m", "out/toy", "-r", "2", "--eval",
            "--registry", path, "--allow_default_orbit"]
    j, t = (common.model_args_from(p.parse_args(argv))
            for common, p in zip((jcommon, tcommon), parsers))
    assert vars(j) == vars(t)
    assert t.source_path == os.path.abspath("data/toy") and t.resolution == 2
