"""Port parity, render CLI: the port's ``render`` CLI with ``--device cpu``
against the JAX CLI (``--backend xla``) on a ``make_colmap_scene``
fixture, the port's synthetic COLMAP writer, and the checkpoint cascade.

PNGs hold 8-bit values, so an image error of a few 1e-5 can move a value
across a quantisation step: renders agree to 1 step everywhere and
exactly on at least 99% of values.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from multiview_inpaint_tpu.gs import gaussians as jgaussians
from multiview_inpaint_tpu.gs.scene import Scene as JScene
from multiview_inpaint_tpu.pipelines import render as jrender_cli
from multiview_inpaint_tpu.utils import synthetic as jsynthetic
from multiview_inpaint_tpu_torch.gs import gaussians as tgaussians
from multiview_inpaint_tpu_torch.gs import scene as tscene
from multiview_inpaint_tpu_torch.pipelines import render as trender_cli
from multiview_inpaint_tpu_torch.utils import synthetic as tsynthetic


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    jsynthetic.make_colmap_scene(str(root), n_views=3)
    return str(root)


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(np.int16)


def _assert_pngs_close(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names and names == sorted(os.listdir(dir_b))
    exact = []
    for n in names:
        a, b = _png(os.path.join(dir_a, n)), _png(os.path.join(dir_b, n))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, n
        exact.append(np.mean(a == b))
    assert min(exact) >= 0.99


def test_render_cli_matches_jax_cli(colmap_scene, tmp_path):
    ply = str(tmp_path / "gt.ply")
    jgaussians.save_ply(jsynthetic.make_gt_gaussians(n=48, seed=1), ply)
    models = {}
    for name in ("jax", "torch"):
        model = tmp_path / name
        dst = model / "point_cloud" / "iteration_7" / "point_cloud.ply"
        dst.parent.mkdir(parents=True)
        shutil.copy(ply, dst)
        models[name] = str(model)
    common = ["-s", colmap_scene, "--resolution", "1", "--save_depth",
              "--skip_test"]
    jrender_cli.main(common + ["-m", models["jax"], "--backend", "xla"])
    trender_cli.main(common + ["-m", models["torch"], "--device", "cpu"])
    for sub in ("renders", "depth"):
        _assert_pngs_close(
            os.path.join(models["jax"], "train", "ours_7", sub),
            os.path.join(models["torch"], "train", "ours_7", sub))
    gt_a = os.path.join(models["jax"], "train", "ours_7", "gt")
    gt_b = os.path.join(models["torch"], "train", "ours_7", "gt")
    for n in sorted(os.listdir(gt_a)):
        assert np.array_equal(_png(os.path.join(gt_a, n)),
                              _png(os.path.join(gt_b, n)))


def test_make_colmap_scene_matches_jax(colmap_scene, tmp_path):
    root = str(tmp_path / "port_scene")
    gt = tsynthetic.make_colmap_scene(root, n_views=3, device="cpu")
    jgt = jsynthetic.make_gt_gaussians()
    np.testing.assert_array_equal(gt.xyz.numpy(), np.asarray(jgt.xyz))
    np.testing.assert_array_equal(gt.opacity.numpy(), np.asarray(jgt.opacity))
    sparse = os.path.join("sparse", "0")
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(root, sparse, f), "rb") as a, \
                open(os.path.join(colmap_scene, sparse, f), "rb") as b:
            assert a.read() == b.read(), f
    _assert_pngs_close(os.path.join(colmap_scene, "images"),
                       os.path.join(root, "images"))


def test_scene_checkpoint_cascade(colmap_scene, tmp_path):
    model = tmp_path / "model"
    pc = model / "point_cloud"
    plys = {}
    for i, sub in enumerate(("iteration_3", "iteration_10", "del", "add")):
        p = jsynthetic.make_gt_gaussians(n=5 + i, seed=i)
        path = pc / sub / "point_cloud.ply"
        path.parent.mkdir(parents=True)
        jgaussians.save_ply(p, str(path))
        plys[sub] = np.asarray(p.xyz)
    kw = dict(resolution=1, shuffle=False, load_iteration=-1)
    for expect, drop in (("add", None), ("del", "add"),
                         ("iteration_10", "del")):
        if drop:
            shutil.rmtree(pc / drop)
        s = tscene.Scene(colmap_scene, str(model), device="cpu", **kw)
        j = JScene(colmap_scene, str(model), **kw)
        np.testing.assert_array_equal(s.gaussians.xyz.numpy(), plys[expect])
        np.testing.assert_array_equal(s.gaussians.xyz.numpy(),
                                      np.asarray(j.gaussians.xyz))
        assert s.loaded_iteration == j.loaded_iteration
        assert [c.image_name for c in s.train_cameras()] == \
            [c.image_name for c in j.train_cameras()]
    assert s.loaded_iteration == 10 == tscene._max_iteration(str(pc))
    s2 = tscene.Scene(colmap_scene, str(model), device="cpu", resolution=1,
                      load_iteration=3)
    np.testing.assert_array_equal(s2.gaussians.xyz.numpy(),
                                  plys["iteration_3"])
    # Without a checkpoint, the point cloud initialises the gaussians.
    s3 = tscene.Scene(colmap_scene, str(model), device="cpu", resolution=1)
    assert s3.gaussians.capacity == 300 and s3.loaded_iteration is None
    saved = s3.save(s3.gaussians, 20)
    back = tgaussians.load_ply(saved, 0, device="cpu")
    assert torch.equal(back.xyz, s3.gaussians.xyz)
