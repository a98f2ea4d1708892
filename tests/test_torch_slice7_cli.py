"""Port parity, the slice-7 CLIs ``sds_train`` and ``gen_depth`` of the
port (``--device cpu``) against the JAX CLIs, on the workspace of
``test_torch_stage2_cli.py`` (``_build``: a 3-view 64x48 COLMAP scene, a
48-splat background and del PLY, an insertion box, the orbit tree of
modes x1, x2 and ``bds_train``). Each package works on its own copy of
the workspace. (``gen_depth --dpt_ckpt`` and ``ctrl_inpaint``:
``test_torch_slice7_prior_cli.py``.)

Bars:
- ``sds_train --no_sds``, 6 iterations on the ``bds_train`` views with
  the background loss, densification off, both given JAX's box samples
  and the JAX CLI an exact pair budget: the logged pairs and points
  equal, the losses within 2e-3 relative (the initial states differ in
  the new splats' 3-NN log-scales, by up to 4 eps |x|^2 / d2 in each
  package: 1.4e-4 at step 1, 8.3e-4 seen at step 3, on a background
  loss of 2.4e-3), every field of the PLY within
  1e-6 + 2 lr x iterations of the JAX one (Adam's sign-flip allowance,
  as ``test_torch_stage2_rec.py``; the rotations of these isotropic
  splats have gradients of rounding noise and differ by up to 8.6 lr),
  xyz, features_dc and opacity within 0.2 lr everywhere (0.08 lr seen)
  and scaling beyond 0.1 lr on at most 5% of the entries (3.8% seen).
- ``gen_depth`` rendering disparity from one SDS PLY (the JAX CLI's):
  every PNG exactly equal. ``--from_est``: the files copied byte for
  byte.
- Guards, in a clean subprocess: the slice-7 modules import neither JAX
  nor the JAX package, and ``sds_train``, ``gen_depth`` and
  ``ctrl_inpaint`` raise "no CUDA device" on their default device
  without a card.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import jax
import pytest
import torch
from PIL import Image

from multiview_inpaint_tpu.config import registries as jreg
from multiview_inpaint_tpu.pipelines import gen_depth as jgen_depth
from multiview_inpaint_tpu.pipelines import sds_train as jsds_train
from multiview_inpaint_tpu_torch.config import registries as treg
from multiview_inpaint_tpu_torch.gs import obb as tobb
from multiview_inpaint_tpu_torch.gs import ply_io
from multiview_inpaint_tpu_torch.gs import scene as tscene
from multiview_inpaint_tpu_torch.models.gs_trainer import INPAINT_OPT
from multiview_inpaint_tpu_torch.pipelines import gen_depth as tgen_depth
from multiview_inpaint_tpu_torch.pipelines import sds_train as tsds_train
from test_torch_stage2_cli import (FRAMES, ITER, REGISTRY_DICTS, SCENE,
                                   SCENE_ID, _build)

N_SAMPLES, SDS_ITERS = 256, 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE7 = ("diffusion.unet2d", "diffusion.controlnet2d", "guidance.sds",
          "models.sds_trainer", "models.dpt", "pipelines.sds_train",
          "pipelines.gen_depth", "pipelines.ctrl_inpaint")


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    saved = [(mod, name, dict(getattr(mod, name)))
             for mod in (jreg, treg) for name in REGISTRY_DICTS]
    base = tmp_path_factory.mktemp("slice7")
    _build(str(base))
    out = {"base": str(base)}
    for name in ("jax", "port"):
        shutil.copytree(base / "ws", base / name)
        out[name] = str(base / name)
    yield out
    for mod, name, d in saved:
        getattr(mod, name).clear()
        getattr(mod, name).update(d)


def _common(ws, name):
    base = ws["base"]
    return ["-s", os.path.join(base, "dataset", SCENE), "--scene_id",
            SCENE_ID, "--workspace", ws[name], "--resolution", "1",
            "--registry", os.path.join(base, "registry.json")]


def _sds_ply(ws, name):
    return os.path.join(ws["base"], "sds", name, "point_cloud",
                        f"iteration_{SDS_ITERS}", "point_cloud.ply")


def test_sds_train_no_sds_matches_jax(ws, monkeypatch):
    u = torch.from_numpy(np.array(jax.random.uniform(jax.random.key(0),
                                                     (N_SAMPLES, 3))))
    real = tobb.sample_uniform
    monkeypatch.setattr(
        tobb, "sample_uniform",
        lambda box, generator, n, u=None, jax_u=u: real(box, generator, n,
                                                        u=jax_u))
    base = ws["base"]
    for name, main, extra in (
            ("jax", jsds_train.main, ["--max_per_tile", "1024",
                                      "--pair_budget_mult", "64"]),
            ("port", tsds_train.main, ["--device", "cpu"])):
        main(_common(ws, name) + [
            "-m", os.path.join(base, "sds", name), "--bg_model",
            os.path.join(base, "output", SCENE), "--bg_iteration",
            str(ITER), "--no_sds", "--iterations", str(SDS_ITERS),
            "--save_iterations", str(SDS_ITERS), "--densify_from_iter",
            "100000", "--opacity_reset_interval", "100000", "--n_samples",
            str(N_SAMPLES), "--log_interval", "3"] + extra)
    a = ply_io.load_gaussian_ply(_sds_ply(ws, "jax"), 0)
    b = ply_io.load_gaussian_ply(_sds_ply(ws, "port"), 0)
    assert len(a["xyz"]) == len(b["xyz"]) == 48 + N_SAMPLES
    extent = tscene.Scene(os.path.join(base, "dataset", SCENE),
                          os.path.join(base, "sds", "scene"), resolution=1,
                          load_images=False, load_gaussians=False,
                          device="cpu").cameras_extent
    cfg = INPAINT_OPT
    lrs = {"xyz": cfg.position_lr_init * extent,
           "features_dc": cfg.feature_lr, "opacity": cfg.opacity_lr,
           "scaling": cfg.scaling_lr, "rotation": cfg.rotation_lr}
    for f, lr in lrs.items():
        diff = np.abs(a[f] - b[f])
        assert (diff <= 1e-6 + 2 * lr * SDS_ITERS).all(), f
        if f in ("xyz", "features_dc", "opacity"):
            assert (diff <= 0.2 * lr).all(), (f, diff.max() / lr)
        elif f == "scaling":
            assert np.mean(diff > 0.1 * lr) <= 0.05, np.mean(diff > 0.1 * lr)
    logs = {}
    for name in ("jax", "port"):
        with open(os.path.join(base, "sds", name, "train_log.jsonl")) as f:
            logs[name] = [json.loads(line) for line in f]
    assert [(r["step"], r["pairs"], r["points"]) for r in logs["port"]] == [
        (r["step"], r["pairs"], r["points"]) for r in logs["jax"]]
    assert len(logs["port"]) == 2
    for r, q in zip(logs["port"], logs["jax"]):
        assert abs(r["loss"] - q["loss"]) <= 2e-3 * q["loss"], (r, q)


def _gen_depth(ws, name, extra):
    main = jgen_depth.main if name == "jax" else tgen_depth.main
    dev = ["--backend", "xla"] if name == "jax" else ["--device", "cpu"]
    main(_common(ws, name) + [
        "-m", os.path.join(ws["base"], "output", SCENE), "--sds_model",
        os.path.dirname(os.path.dirname(os.path.dirname(_sds_ply(
            ws, "jax")))), "--sds_iteration", str(SDS_ITERS), "--frames",
        str(FRAMES)] + dev + extra)
    return os.path.join(ws[name], "inpaint", "depth", SCENE_ID)


def _pngs(root, modes=("x1", "x2")):
    out = {}
    for mode in modes:
        for f in sorted(os.listdir(os.path.join(root, mode))):
            with Image.open(os.path.join(root, mode, f)) as im:
                out[(mode, f)] = np.asarray(im).astype(np.int16)
    return out


def test_gen_depth_rendered_matches_jax(ws):
    assert os.path.exists(_sds_ply(ws, "jax")), "run after sds_train"
    got, want = (_pngs(_gen_depth(ws, name, [])) for name in ("port", "jax"))
    assert sorted(got) == sorted(want) and len(got) == 2 * FRAMES
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
        assert got[k].max() > got[k].min()


def test_gen_depth_from_est_copies_the_maps(ws):
    est = os.path.join(ws["base"], "est")
    for mode in ("x1", "x2"):
        os.makedirs(os.path.join(est, mode))
        for i in range(FRAMES):
            Image.fromarray(np.full((8, 8), 40 * i + 7, np.uint8)).save(
                os.path.join(est, mode, f"{i:02d}.png"))
    for name in ("jax", "port"):
        out = os.path.join(ws["base"], f"est_{name}")
        main = jgen_depth.main if name == "jax" else tgen_depth.main
        main(["--scene_id", SCENE_ID, "--from_est", est, "--workspace", out,
              "--registry", os.path.join(ws["base"], "registry.json")])
        for mode in ("x1", "x2"):
            d = os.path.join(out, "inpaint", "depth", SCENE_ID, mode)
            assert sorted(os.listdir(d)) == [f"{i:02d}.png"
                                             for i in range(FRAMES)]
            for f in os.listdir(d):
                assert filecmp.cmp(os.path.join(d, f),
                                   os.path.join(est, mode, f), shallow=False)


def test_slice7_guards(ws):
    """One clean subprocess (the test process has imported both
    packages): it imports the slice-7 modules and lists what JAX modules
    came with them, then calls the three CLIs on the default device and
    reports what each raised."""
    base = ws["base"]
    code = f"""
        import importlib, json, sys
        want = ["multiview_inpaint_tpu_torch." + m for m in {SLICE7!r}]
        for name in want:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "multiview_inpaint_tpu"))
        from multiview_inpaint_tpu_torch.pipelines import (
            ctrl_inpaint, gen_depth, sds_train)
        common = ["-s", "{base}/dataset/{SCENE}", "--scene_id",
                  "{SCENE_ID}", "--workspace", "{ws['port']}",
                  "--registry", "{base}/registry.json"]
        calls = [
            (sds_train.main, common + ["-m", "{base}/sds/gpu", "--bg_model",
                                       "{base}/output/{SCENE}", "--no_sds"]),
            (gen_depth.main, common + ["-m", "{base}/output/{SCENE}"]),
            (ctrl_inpaint.main, ["--scene_id", "{SCENE_ID}", "--sd_ckpt",
                                 "sd.ckpt", "--ctrl_ckpt", "ctrl.ckpt",
                                 "--text_embs", "embs.npy"])]
        raised = []
        for main, argv in calls:
            try:
                main(argv)
                raised.append(None)
            except Exception as e:
                raised.append(f"{{type(e).__name__}}: {{e}}")
        print(json.dumps({{"jax": bad, "raised": raised}}))
    """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["jax"] == [], out
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    for raised in out["raised"]:
        assert raised and raised.startswith("RuntimeError") and (
            "no CUDA device" in raised), out["raised"]
