"""Port parity, stage-1 CLIs: ``gen_seq`` (with ``--sds``),
``render_depth``, ``delete``, ``gen_pc``, ``vis_render`` and ``vis`` of the
port with ``--device cpu`` against the JAX CLIs with ``--backend xla``, on
a 3-view 64x48 ``make_colmap_scene`` and a ``make_gt_gaussians(n=48)``
PLY. Each package reads its own ``--registry`` JSON (front view, orbit
and vis parameters); the registries are restored afterwards.

Tolerances:
- renders, ``masked``, disparity and ``vis_render`` frames: PNGs hold
  8-bit values, so they agree to 1 step everywhere and exactly on at
  least 99% of values (the bar of ``test_torch_render_cli.py``);
- masks (orbit and ``bds_train``): equal on every pixel except where the
  float64 box t and the port's rendered depth lie within 1e-4 of each
  other (counted and printed);
- ``poses.npy``, ``cam_center.npy``, ``xyz.ply`` and the GIF's frames:
  exactly equal;
- ``delete``: the same rows kept except rows whose +-x rays are fragile
  (within 1e-6 of a face, ``obb.fragile_rays``; counted and printed), and
  byte-identical PLYs when there are none.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from multiview_inpaint_tpu.config import registries as jreg
from multiview_inpaint_tpu.gs import gaussians as jgaussians
from multiview_inpaint_tpu.gs import obb as jobb
from multiview_inpaint_tpu.pipelines import delete as jdelete
from multiview_inpaint_tpu.pipelines import gen_pc as jgen_pc
from multiview_inpaint_tpu.pipelines import gen_seq as jgen_seq
from multiview_inpaint_tpu.pipelines import render_depth as jrender_depth
from multiview_inpaint_tpu.pipelines import vis as jvis
from multiview_inpaint_tpu.pipelines import vis_render as jvis_render
from multiview_inpaint_tpu.utils import synthetic as jsynthetic
from multiview_inpaint_tpu_torch.config import registries as treg
from multiview_inpaint_tpu_torch.gs import cameras as tcameras
from multiview_inpaint_tpu_torch.gs import gaussians as tgaussians
from multiview_inpaint_tpu_torch.gs import obb as tobb
from multiview_inpaint_tpu_torch.gs import ply_io
from multiview_inpaint_tpu_torch.gs import scene as tscene
from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera, render
from multiview_inpaint_tpu_torch.pipelines import delete as tdelete
from multiview_inpaint_tpu_torch.pipelines import gen_pc as tgen_pc
from multiview_inpaint_tpu_torch.pipelines import gen_seq as tgen_seq
from multiview_inpaint_tpu_torch.pipelines import render_depth as trender_depth
from multiview_inpaint_tpu_torch.pipelines import vis as tvis
from multiview_inpaint_tpu_torch.pipelines import vis_render as tvis_render
from multiview_inpaint_tpu_torch.utils import synthetic as tsynthetic

SCENE_ID, ITER, FRAMES = "toy_case", 7, 2
DEPTH_NEAR_T = 1e-4
REGISTRY = {"front_views": {"toy": "view00"},
            "orbit_params": {"toy": {"k_lift": 0.3, "r_scale": 0.9,
                                     "k_bias": 0.1}},
            "vis_params": {"toy": {"k_lift": 0.2, "r_scale": 0.8,
                                   "view_range": 0.9}}}
REGISTRY_DICTS = ("FRONT_VIEWS", "INSERTION_PROMPTS", "ORBIT_PARAMS",
                  "VIS_PARAMS")
PACKAGES = {"jax": (jsynthetic, ["--backend", "xla"]),
            "port": (tsynthetic, ["--device", "cpu"])}


def _model(root, ply):
    dst = os.path.join(root, "point_cloud", f"iteration_{ITER}",
                       "point_cloud.ply")
    os.makedirs(os.path.dirname(dst))
    shutil.copy(ply, dst)
    return root


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    saved = [(mod, name, dict(getattr(mod, name)))
             for mod in (jreg, treg) for name in REGISTRY_DICTS]
    root = tmp_path_factory.mktemp("stage1")
    src = str(root / "dataset" / "toy")
    tsynthetic.make_colmap_scene(src, n_views=3, device="cpu")
    ply = str(root / "gt.ply")
    jgaussians.save_ply(jsynthetic.make_gt_gaussians(n=48, seed=1), ply)
    out = {"src": src, "ply": ply, "root": str(root)}
    for name, (synthetic, extra) in PACKAGES.items():
        base = root / name
        model = _model(str(base / "output" / "toy"), ply)
        work = str(base / "ws")
        synthetic.write_cube_obj(os.path.join(work, "bds", "add",
                                              f"{SCENE_ID}.obj"),
                                 center=(0.1, 0.05, 0.0), half=0.35)
        registry = str(base / "registry.json")
        with open(registry, "w") as f:
            json.dump(REGISTRY, f)
        out[name] = {"model": model, "ws": work, "extra": extra,
                     "args": ["-s", src, "-m", model, "--scene_id",
                              SCENE_ID, "--resolution", "1", "--workspace",
                              work, "--registry", registry] + extra}
    jgen_seq.main(out["jax"]["args"] + ["--frames", str(FRAMES),
                                        "--max_per_tile", "256"])
    tgen_seq.main(out["port"]["args"] + ["--frames", str(FRAMES)])
    yield out
    for mod, name, d in saved:
        getattr(mod, name).clear()
        getattr(mod, name).update(d)


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(np.int16)


def _assert_pngs_close(dir_a, dir_b, count):
    names = sorted(os.listdir(dir_a))
    assert len(names) == count and names == sorted(os.listdir(dir_b))
    exact = []
    for n in names:
        a, b = _png(os.path.join(dir_a, n)), _png(os.path.join(dir_b, n))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, n
        exact.append(np.mean(a == b))
    assert min(exact) >= 0.99
    return names


def _seq(ws, mode, root="inpaint"):
    return os.path.join(ws, root, "seq", SCENE_ID, mode, f"ours_{ITER}")


def _box_t64(box, view):
    """Float64 box t of every pixel ray of ``view``."""
    o, d = (torch.from_numpy(a).double() for a in tcameras.get_rays(view))
    d = d / d.norm(dim=-1, keepdim=True)
    t, _ = tobb._intersect(torch.from_numpy(
        box.face_verts.astype(np.float64)), o, d)
    return t.reshape(view.height, view.width).numpy()


def _views(ws, mode):
    scene = tscene.Scene(ws["src"], ws["port"]["model"], resolution=1,
                         shuffle=False, load_gaussians=False)
    if mode == "bds_train":
        return scene.train_cameras()
    o = treg.ORBIT_PARAMS["toy"]
    front = next(c for c in scene.train_cameras()
                 if c.image_name == "view00")
    box = tobb.load_obb(os.path.join(ws["port"]["ws"], "bds", "add",
                                     f"{SCENE_ID}.obj"))
    return tscene.orbit_cameras(front, box, mode=mode, frames=FRAMES,
                                view_range=o.view_range, r_scale=o.r_scale,
                                k_lift=o.k_lift, k_bias=o.k_bias)


@pytest.mark.parametrize("mode", ["x1", "x2", "bds_train"])
def test_gen_seq_matches_jax(ws, mode):
    a, b = _seq(ws["jax"]["ws"], mode), _seq(ws["port"]["ws"], mode)
    count = 3 if mode == "bds_train" else FRAMES
    for sub in ("renders", "masked"):
        _assert_pngs_close(os.path.join(a, sub), os.path.join(b, sub),
                           count)
    box = tobb.load_obb(os.path.join(ws["port"]["ws"], "bds", "add",
                                     f"{SCENE_ID}.obj"))
    params = tgaussians.load_ply(ws["ply"], 0, device="cpu")
    near, on = 0, 0
    for view in _views(ws, mode):
        name = f"{view.image_name}.png"
        mj = _png(os.path.join(a, "mask", name))
        mp = _png(os.path.join(b, "mask", name))
        assert set(np.unique(mp)) <= {0, 255} and mp.shape == (
            view.height, view.width)
        with torch.no_grad():
            depth = render(params, RenderCamera.from_camera(view, "cpu"),
                           torch.zeros(3), device="cpu").depth.numpy()
        t = _box_t64(box, view)
        close = (t > 0) & (np.abs(t - depth) < DEPTH_NEAR_T)
        assert not ((mj != mp) & ~close).any(), name
        near += int(close.sum())
        on += int((mp > 0).sum())
    print(f"{mode}: {on} mask pixels, {near} within {DEPTH_NEAR_T} of the "
          f"depth")
    assert on > 0
    if mode != "bds_train":
        for f in ("poses.npy", "cam_center.npy"):
            x, y = np.load(os.path.join(a, f)), np.load(os.path.join(b, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert np.load(os.path.join(b, "poses.npy")).shape == (FRAMES, 4, 4)
    else:
        assert not os.path.exists(os.path.join(b, "poses.npy"))


def test_gen_seq_sds_writes_inpaint_sds(ws):
    tgen_seq.main(ws["port"]["args"] + ["--frames", str(FRAMES), "--sds",
                                        "--modes", "x1"])
    sds = _seq(ws["port"]["ws"], "x1", "inpaint_sds")
    plain = _seq(ws["port"]["ws"], "x1")
    for sub in ("renders", "mask", "masked"):
        names = sorted(os.listdir(os.path.join(sds, sub)))
        assert names == ["00.png", "01.png"]
        for n in names:
            assert np.array_equal(_png(os.path.join(sds, sub, n)),
                                  _png(os.path.join(plain, sub, n)))
    assert os.path.exists(os.path.join(sds, "poses.npy"))
    assert not os.path.exists(os.path.join(ws["port"]["ws"], "inpaint_sds",
                                           "seq", SCENE_ID, "bds_train"))


def test_render_depth_matches_jax(ws):
    jrender_depth.main(ws["jax"]["args"] + ["--frames", str(FRAMES)])
    trender_depth.main(ws["port"]["args"] + ["--frames", str(FRAMES)])
    for mode in ("x1", "x2"):
        _assert_pngs_close(os.path.join(_seq(ws["jax"]["ws"], mode), "disp"),
                           os.path.join(_seq(ws["port"]["ws"], mode),
                                        "disp"), FRAMES)


def test_vis_render_and_vis_match_jax(ws):
    dirs = {}
    for name, main in (("jax", jvis_render.main),
                       ("port", tvis_render.main)):
        w = ws[name]
        main(["-s", ws["src"], "-m", w["model"], "--scene_id", SCENE_ID,
              "--resolution", "1", "--workspace", w["ws"], "--registry",
              os.path.join(os.path.dirname(w["ws"]), "registry.json"),
              "--src", "--frames", "4", "--iteration", str(ITER)]
             + w["extra"])
        dirs[name] = os.path.join(w["ws"], "vis", "vis_video", "src",
                                  SCENE_ID, "renders")
    # x1's two frames reversed, then x2's second
    names = _assert_pngs_close(dirs["jax"], dirs["port"], 3)
    assert names == ["00000.png", "00001.png", "00002.png"]
    gifs = {}
    for name, main in (("jax", jvis.main), ("port", tvis.main)):
        gifs[name] = os.path.join(ws["root"], f"{name}.gif")
        main(["--frames_dir", dirs["port"], "--out", gifs[name]])
    frames = {}
    for name, path in gifs.items():
        with Image.open(path) as im:
            frames[name] = [np.asarray(f.convert("RGB"))
                            for f in ImageSequence.Iterator(im)]
    assert len(frames["port"]) == len(frames["jax"]) == 3
    for x, y in zip(frames["jax"], frames["port"]):
        assert np.array_equal(x, y)


def test_delete_matches_jax(ws, tmp_path):
    src = tgaussians.load_ply(ws["ply"], 0, device="cpu").xyz.numpy()
    kept, plys = {}, {}
    for name, main in (("jax", jdelete.main), ("port", tdelete.main)):
        model = _model(str(tmp_path / name), ws["ply"])
        box = str(tmp_path / f"{name}_del.obj")
        PACKAGES[name][0].write_cube_obj(box, center=(0.05, -0.1, 0.0),
                                         half=0.45)
        main(["-m", model, "--box", box, "--iteration", str(ITER)]
             + (["--device", "cpu"] if name == "port" else []))
        plys[name] = os.path.join(model, "point_cloud", "del",
                                  "point_cloud.ply")
        kept[name] = ply_io.load_gaussian_ply(plys[name], 0)["xyz"]
    box = tobb.load_obb(str(tmp_path / "port_del.obj"))
    inside = {"port": tobb.contains(box, torch.from_numpy(src)).numpy(),
              "jax": np.asarray(jobb.contains(jobb.load_obb(
                  str(tmp_path / "jax_del.obj")), jnp.asarray(src)))}
    for name in kept:
        np.testing.assert_array_equal(kept[name], src[~inside[name]])
    dx = np.zeros_like(src)
    dx[:, 0] = 1.0
    fragile = (tobb.fragile_rays(box, src, dx)
               | tobb.fragile_rays(box, src, -dx))
    print(f"delete: {int(inside['port'].sum())} of {len(src)} rows inside, "
          f"{int(fragile.sum())} within 1e-6 of a face")
    assert 0 < inside["port"].sum() < len(src)
    assert not ((inside["jax"] != inside["port"]) & ~fragile).any()
    if not fragile.any():
        with open(plys["jax"], "rb") as a, open(plys["port"], "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("sample_num", [20, 10000])
def test_gen_pc_matches_jax(ws, tmp_path, sample_num):
    out = {}
    for name, main in (("jax", jgen_pc.main), ("port", tgen_pc.main)):
        model = _model(str(tmp_path / name), ws["ply"])
        main(["-m", model, "--iteration", str(ITER), "--sample_num",
              str(sample_num)])
        with open(os.path.join(model, "xyz.ply"), "rb") as f:
            out[name] = f.read()
    assert out["jax"] == out["port"]
    pts, _, _ = ply_io.fetch_point_cloud(os.path.join(str(tmp_path / "port"),
                                                      "xyz.ply"))
    assert len(pts) == min(sample_num, 48)
