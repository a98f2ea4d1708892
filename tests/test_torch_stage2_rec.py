"""Port parity, the stage-2 ``inpaint_rec`` CLI of the port (``--device
cpu``) against the JAX CLI, on the workspace of
``test_torch_stage2_cli.py`` (``_build``: a 3-view 64x48 COLMAP scene, a
48-splat background and del PLY, an insertion box, the orbit tree of modes
x1, x2 at 48x64 and "inpainted" frames at 56x72) with the port's
``seg_masks --auto`` masks for ctrl 1.

Bars:
- ``inpaint_rec``, 6 iterations (3 inpainted views at 56x72 with the full
  loss and 3 background-masked training views at 64x48), densification
  off, both given JAX's box samples (the test hooks the port's
  ``obb.sample_uniform`` to take ``jax.random.uniform(key(0))``, what the
  JAX CLI draws) and the JAX CLI an exact pair budget (``--max_per_tile
  1024 --pair_budget_mult 64``: at 256 per tile it drops pairs): the
  logged pairs and points equal and the logged losses within 5e-4
  relative (1.7e-4 seen at step 6); every field of the final PLY within
  1e-6 + 2 lr x iterations of the JAX one, since an entry whose gradient
  lies below the gradient bar may take Adam's other sign at any step
  (``test_torch_train``): the rotation gradients of these isotropic
  splats are rounding noise, and the rotations do differ by up to 6.6 lr;
  and at most 2% of the entries of xyz, features_dc and opacity beyond
  1e-2 lr (0.8%, 0% and 0.3% seen), 1% of scaling's beyond 0.1 lr (0.1%
  seen).
"""

import json
import os

import numpy as np
import jax
import pytest
import torch

from multiview_inpaint_tpu.config import registries as jreg
from multiview_inpaint_tpu.pipelines import inpaint_rec as jinpaint_rec
from multiview_inpaint_tpu_torch.config import registries as treg
from multiview_inpaint_tpu_torch.gs import obb as tobb
from multiview_inpaint_tpu_torch.gs import ply_io
from multiview_inpaint_tpu_torch.gs import scene as tscene
from multiview_inpaint_tpu_torch.models import gs_trainer
from multiview_inpaint_tpu_torch.pipelines import inpaint_rec as tinpaint_rec
from multiview_inpaint_tpu_torch.pipelines import seg_masks as tseg_masks
from test_torch_stage2_cli import (FRAMES, INP_HW, ITER, REGISTRY_DICTS,
                                   SCENE, SCENE_ID, _build)

N_SAMPLES, REC_ITERS = 256, 6
# (share of entries, multiple of the lr): at most that share of a field's
# entries may differ by more than that multiple of its learning rate.
SHARE_BARS = {"xyz": (0.02, 1e-2), "features_dc": (0.02, 1e-2),
              "opacity": (0.02, 1e-2), "scaling": (0.01, 1e-1)}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    saved = [(mod, name, dict(getattr(mod, name)))
             for mod in (jreg, treg) for name in REGISTRY_DICTS]
    base = tmp_path_factory.mktemp("stage2_rec")
    _build(str(base))
    tseg_masks.main(["--scene_id", SCENE_ID, "--ctrl_id", "1", "--auto",
                     "--frames", str(FRAMES), "--iteration", str(ITER),
                     "--workspace", str(base / "ws")])
    yield {"base": str(base), "jax": str(base / "ws"),
           "port": str(base / "ws")}
    for mod, name, d in saved:
        getattr(mod, name).clear()
        getattr(mod, name).update(d)


def test_inpaint_rec_matches_jax(ws, monkeypatch):
    u = torch.from_numpy(np.array(jax.random.uniform(jax.random.key(0),
                                                     (N_SAMPLES, 3))))
    real = tobb.sample_uniform
    monkeypatch.setattr(
        tobb, "sample_uniform",
        lambda box, generator, n, u=None, jax_u=u: real(box, generator, n,
                                                        u=jax_u))
    steps = []
    real_step = gs_trainer.train_step

    def step(*a, **kw):
        steps.append((kw["loss_mode"], tuple(a[2].shape)))
        return real_step(*a, **kw)

    monkeypatch.setattr(gs_trainer, "train_step", step)
    base = ws["base"]
    plys = {}
    for name, main, extra in (
            ("jax", jinpaint_rec.main, ["--max_per_tile", "1024",
                                        "--pair_budget_mult", "64"]),
            ("port", tinpaint_rec.main, ["--device", "cpu"])):
        out = os.path.join(base, "rec", name)
        main(["-s", os.path.join(base, "dataset", SCENE), "-m", out,
              "--scene_id", SCENE_ID, "--ctrl_id", "1", "--bg_model",
              os.path.join(base, "output", SCENE), "--bg_iteration",
              str(ITER), "--workspace", ws[name], "--resolution", "1",
              "--frames", str(FRAMES), "--registry",
              os.path.join(base, "registry.json"), "--iterations",
              str(REC_ITERS), "--save_iterations", str(REC_ITERS),
              "--densify_from_iter", "100000", "--opacity_reset_interval",
              "100000", "--n_samples", str(N_SAMPLES), "--log_interval",
              "3"] + extra)
        plys[name] = os.path.join(out, "ctrl_1", "point_cloud",
                                  f"iteration_{REC_ITERS}", "point_cloud.ply")
    assert sorted(steps) == sorted(
        [("full", INP_HW + (3,))] * 3 + [("background", (48, 64, 3))] * 3)
    a = ply_io.load_gaussian_ply(plys["jax"], 0)
    b = ply_io.load_gaussian_ply(plys["port"], 0)
    assert len(a["xyz"]) == len(b["xyz"]) == 48 + N_SAMPLES
    extent = tscene.Scene(os.path.join(base, "dataset", SCENE),
                          os.path.join(base, "rec", "scene"), resolution=1,
                          load_images=False, load_gaussians=False,
                          device="cpu").cameras_extent
    init = tscene.load_sd_ply(
        os.path.join(base, "output", SCENE, "point_cloud", "del",
                     "point_cloud.ply"),
        tobb.load_obb(os.path.join(ws["port"], "bds", "add",
                                   f"{SCENE_ID}.obj")),
        n_samples=N_SAMPLES, u=u, device="cpu")
    cfg = gs_trainer.OptimizationConfig()
    lrs = {"xyz": cfg.position_lr_init * extent,
           "features_dc": cfg.feature_lr, "opacity": cfg.opacity_lr,
           "scaling": cfg.scaling_lr, "rotation": cfg.rotation_lr}
    err, moved = {}, {}
    for f, lr in lrs.items():
        diff = np.abs(a[f] - b[f])
        err[f] = float(diff.max())
        moved[f] = float(np.abs(b[f] - getattr(init, f)[
            :48 + N_SAMPLES].numpy().reshape(b[f].shape)).max())
        assert (diff <= 1e-6 + 2 * lr * REC_ITERS).all(), f
        if f in SHARE_BARS:
            share, scale = SHARE_BARS[f]
            assert np.mean(diff > scale * lr) <= share, (
                f, np.mean(diff > scale * lr))
    print(f"inpaint_rec: max |port - jax| {err}, max move from the init "
          f"{moved}")
    assert all(m > 0 for m in moved.values())
    logs = {}
    for name, ply in plys.items():
        with open(os.path.join(os.path.dirname(os.path.dirname(
                os.path.dirname(ply))), "train_log.jsonl")) as f:
            logs[name] = [json.loads(line) for line in f]
    assert [(r["step"], r["pairs"], r["points"]) for r in logs["port"]] == [
        (r["step"], r["pairs"], r["points"]) for r in logs["jax"]]
    for r, q in zip(logs["port"], logs["jax"]):
        assert abs(r["loss"] - q["loss"]) <= 5e-4 * q["loss"], (r, q)
