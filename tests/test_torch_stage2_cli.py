"""Port parity, stage-2 CLIs: ``seg_masks`` of the port (``--device cpu``)
against the JAX CLI on the same workspace, plus the guards of the stage-2
modules (``inpaint_rec``'s parity is ``test_torch_stage2_rec.py``, on the
workspace this module builds).

The workspace: a 3-view 64x48 ``make_colmap_scene``, a
``make_gt_gaussians(n=48)`` background PLY (also as the ``del`` PLY), an
insertion box, the orbit tree that ``gen_seq`` writes (renders and box
masks of modes x1, x2 at 48x64, poses, the box centre, ``bds_train``)
made with the port's ``render_sequence``, and "inpainted" frames at 56x72:
the background and a 12-splat object inside the box rendered together,
resized, for ctrl 0 and ctrl 1. Each package works on its own copy.

Bars:
- ``seg_masks`` (``--auto``, ``--auto --propagate``, ``--auto
  --no_bg_fit``, ``--import_dir``, ``--ground`` with a ``text_features``
  row, ``--ground`` with a text tower and a merges file): every PNG
  exactly equal. The towers are tiny (``TINY_VIT``, a 2-layer width-64
  text tower), seeded port towers written in the JAX layout by the port's
  ``state_dict_to_jax``; the JAX CLI builds its text tower from the
  default ``TextConfig``, so the test points the JAX module's
  ``TextConfig`` at the tiny one (the port reads the geometry off the
  params).
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

from multiview_inpaint_tpu.config import registries as jreg
from multiview_inpaint_tpu.diffusion import clip_text as jtext
from multiview_inpaint_tpu.gs import gaussians as jgaussians
from multiview_inpaint_tpu.gs import scene_io as jscene_io
from multiview_inpaint_tpu.pipelines import seg_masks as jseg_masks
from multiview_inpaint_tpu.utils import synthetic as jsynthetic
from multiview_inpaint_tpu_torch.config import registries as treg
from multiview_inpaint_tpu_torch.diffusion import checkpoint as tckpt
from multiview_inpaint_tpu_torch.diffusion import clip_text as tclip_text
from multiview_inpaint_tpu_torch.diffusion import clip_vit as tclip_vit
from multiview_inpaint_tpu_torch.gs import gaussians as tgaussians
from multiview_inpaint_tpu_torch.gs import obb as tobb
from multiview_inpaint_tpu_torch.gs import scene as tscene
from multiview_inpaint_tpu_torch.guidance import grounding as tground
from multiview_inpaint_tpu_torch.models import gs_trainer
from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera, render
from multiview_inpaint_tpu_torch.pipelines import gen_seq as tgen_seq
from multiview_inpaint_tpu_torch.pipelines import seg_masks as tseg_masks
from multiview_inpaint_tpu_torch.utils import synthetic as tsynthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE, SCENE_ID, ITER, FRAMES = "toy", "toy_case", 7, 2
SEQ_HW, INP_HW = (48, 64), (56, 72)
REGISTRY = {"front_views": {SCENE: "view00"},
            "orbit_params": {SCENE: {"k_lift": 0.3, "r_scale": 0.9,
                                     "k_bias": 0.1}}}
REGISTRY_DICTS = ("FRONT_VIEWS", "INSERTION_PROMPTS", "ORBIT_PARAMS",
                  "VIS_PARAMS")
MERGES = ["t h", "th e</w>", "c h", "a i", "ai r</w>", "r e", "re d</w>",
          "o b", "ob j", "obj e", "obje c", "objec t</w>"]
TINY_TEXT = tclip_text.TextConfig(vocab_size=512 + len(MERGES) + 2,
                             context_length=16, width=64, layers=2, heads=2,
                             output_dim=64)
STAGE2 = ("diffusion.clip_text", "diffusion.clip_vit",
          "diffusion.checkpoint", "guidance.grounding", "gs.scene",
          "pipelines.seg_masks", "pipelines.inpaint_rec")


def _object(center):
    obj = tsynthetic.make_gt_gaussians(n=12, seed=2, spread=0.12,
                                       device="cpu")
    xyz = obj.xyz + torch.tensor(center, dtype=torch.float32)
    return tgaussians.from_arrays(xyz, obj.features_dc, obj.features_rest,
                                  obj.opacity, obj.scaling, obj.rotation,
                                  device="cpu")


def _cat(a, b):
    return tgaussians.from_arrays(
        *(torch.cat([getattr(a, f), getattr(b, f)])
          for f in gs_trainer.PARAM_FIELDS), device="cpu")


def _build(root):
    """The shared workspace (see the module docstring); returns its fovs."""
    src = os.path.join(root, "dataset", SCENE)
    tsynthetic.make_colmap_scene(src, n_views=3, device="cpu")
    model = os.path.join(root, "output", SCENE)
    for sub in (f"iteration_{ITER}", "del"):
        path = os.path.join(model, "point_cloud", sub, "point_cloud.ply")
        os.makedirs(os.path.dirname(path))
        jgaussians.save_ply(jsynthetic.make_gt_gaussians(n=48, seed=1), path)
    ws = os.path.join(root, "ws")
    center = (0.1, 0.05, 0.0)
    box_path = os.path.join(ws, "bds", "add", f"{SCENE_ID}.obj")
    tsynthetic.write_cube_obj(box_path, center=center, half=0.3)
    with open(os.path.join(root, "registry.json"), "w") as f:
        json.dump(REGISTRY, f)
    treg.load_registry_overrides(os.path.join(root, "registry.json"))

    scene = tscene.Scene(src, model, resolution=1, shuffle=False,
                         load_gaussians=False, device="cpu")
    front = scene.front_view()
    box = tobb.load_obb(box_path)
    bg = tgaussians.load_ply(os.path.join(model, "point_cloud",
                                          f"iteration_{ITER}",
                                          "point_cloud.ply"), 0, device="cpu")
    both = _cat(bg, _object(center))
    black = torch.zeros(3)
    seq = os.path.join(ws, "inpaint", "seq", SCENE_ID)
    o = treg.ORBIT_PARAMS[SCENE]
    for mode in ("x1", "x2"):
        views = tscene.orbit_cameras(front, box, mode=mode, frames=FRAMES,
                                     r_scale=o.r_scale, k_lift=o.k_lift,
                                     k_bias=o.k_bias, new_size=SEQ_HW)
        tgen_seq.render_sequence(views, bg, box,
                                 os.path.join(seq, mode, f"ours_{ITER}"),
                                 black, device="cpu")
        for ctrl in (0, 1):
            out = os.path.join(ws, "inpaint", "inpainted", SCENE_ID,
                               f"ctrl_{ctrl}", mode)
            os.makedirs(out)
            for i, view in enumerate(views):
                with torch.no_grad():
                    rgb = render(both, RenderCamera.from_camera(view, "cpu"),
                                 black, device="cpu").rgb.numpy()
                im = Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(
                    np.uint8)).resize(INP_HW[::-1])
                im.save(os.path.join(out, f"{i:02d}.png"))
    tgen_seq.render_sequence(scene.train_cameras(), bg, box,
                             os.path.join(seq, "bds_train", f"ours_{ITER}"),
                             black, save_poses=False, device="cpu")
    return views[0].fovx, views[0].fovy


def _write_clip(path, with_text, frame):
    """A tiny CLIP npz in the JAX layout, written by the port's carrier
    from seeded port towers: the vision tower, its config, and the text
    tower or, as the query row, the vision embedding of ``frame`` (so
    that the full-frame window of that frame scores best)."""
    torch.manual_seed(0)
    vit = tclip_vit.CLIPVisionTower(tclip_vit.TINY_VIT)
    tree = {"vision": tckpt.state_dict_to_jax(
        {tckpt.PREFIXES["clip"] + k: v for k, v in vit.state_dict().items()},
        "clip", clip_heads=tclip_vit.TINY_VIT.heads),
        "vit_cfg": {k: np.asarray(v)
                    for k, v in vars(tclip_vit.TINY_VIT).items()}}
    if with_text:
        text = tclip_text.CLIPTextTower(TINY_TEXT)
        tree["text"] = tckpt.state_dict_to_jax(
            {tckpt.TEXT_PREFIX + k: v for k, v in text.state_dict().items()},
            "clip_text", clip_heads=TINY_TEXT.heads)
    else:
        g = tground.CLIPGrounder(vit.eval())
        with torch.no_grad():
            crop = g.crops(frame, np.array([[0, 0, *frame.shape[:2]]]))
            tree["text_features"] = vit(crop * 2.0 - 1.0)[0].numpy()
    tckpt.save_params(path, tree)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    saved = [(mod, name, dict(getattr(mod, name)))
             for mod in (jreg, treg) for name in REGISTRY_DICTS]
    base = tmp_path_factory.mktemp("stage2")
    fovx, fovy = _build(str(base))
    tseg_masks.main(["--scene_id", SCENE_ID, "--ctrl_id", "1", "--auto",
                     "--frames", str(FRAMES), "--iteration", str(ITER),
                     "--workspace", str(base / "ws")])
    frame = jscene_io.load_image(str(
        base / "ws" / "inpaint" / "inpainted" / SCENE_ID / "ctrl_0" / "x1"
        / "00.png"))
    for name in ("text", "features"):
        _write_clip(str(base / f"clip_{name}.npz"), name == "text", frame)
    with open(base / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    imports = base / "ext"
    for mode in ("x1", "x2"):
        os.makedirs(imports / mode)
        for i in range(FRAMES):
            Image.fromarray(np.full(SEQ_HW, 255 * (i % 2), np.uint8)).save(
                imports / mode / f"{i:02d}.png")
    out = {"base": str(base), "fov": (fovx, fovy)}
    for name in ("jax", "port"):
        shutil.copytree(base / "ws", base / name)
        out[name] = str(base / name)
    yield out
    for mod, name, d in saved:
        getattr(mod, name).clear()
        getattr(mod, name).update(d)


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im)


SEG_CASES = {
    "auto": ["--auto"],
    "auto_propagate": ["--auto", "--propagate"],
    "auto_no_bg_fit": ["--auto", "--no_bg_fit", "--threshold", "0.05"],
    "import_dir": ["--import_dir", "{base}/ext"],
    "ground_features": ["--auto", "--ground", "the object", "--clip_ckpt",
                        "{base}/clip_features.npz", "--ground_min_overlap",
                        "0.3"],
    "ground_text": ["--auto", "--ground", "the red chair", "--clip_ckpt",
                    "{base}/clip_text.npz", "--bpe_vocab",
                    "{base}/merges.txt", "--ground_min_overlap", "0.3"],
}


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_masks_matches_jax(ws, case, monkeypatch):
    tiny = jtext.TextConfig(**vars(TINY_TEXT))
    monkeypatch.setattr(jtext, "TextConfig", lambda: tiny)
    fovx, fovy = ws["fov"]
    extra = [a.format(base=ws["base"]) for a in SEG_CASES[case]]
    if "--propagate" in extra:
        extra += ["--fovx", repr(fovx), "--fovy", repr(fovy)]
    common = ["--scene_id", SCENE_ID, "--ctrl_id", "0", "--frames",
              str(FRAMES), "--iteration", str(ITER)]
    jseg_masks.main(common + ["--workspace", ws["jax"]] + extra)
    tseg_masks.main(common + ["--workspace", ws["port"], "--device", "cpu"]
                    + extra)
    cover = []
    for mode in ("x1", "x2"):
        rel = os.path.join("inpaint", "sam_mask", SCENE_ID, "ctrl_0", mode)
        names = sorted(os.listdir(os.path.join(ws["jax"], rel)))
        assert names == sorted(os.listdir(os.path.join(ws["port"], rel)))
        assert len(names) == FRAMES
        for n in names:
            a = _png(os.path.join(ws["jax"], rel, n))
            b = _png(os.path.join(ws["port"], rel, n))
            assert np.array_equal(a, b), (case, mode, n)
            cover.append(float((b > 0).mean()))
    print(f"{case}: mask cover {cover}")
    if case not in ("import_dir", "ground_text"):  # a random text tower
        assert any(c > 0 for c in cover)


def test_seg_masks_misuse_exits_like_jax(ws):
    for argv, msg in ((["--ground", "x"], "--ground needs --clip_ckpt"),
                      (["--auto", "--propagate"],
                       "--propagate needs --fovx and --fovy"),
                      ([], "pass --import_dir or --auto")):
        argv = ["--scene_id", SCENE_ID, "--frames", str(FRAMES),
                "--iteration", str(ITER), "--workspace", ws["port"]] + argv
        for main in (jseg_masks.main, tseg_masks.main):
            with pytest.raises(SystemExit, match=msg):
                main(argv)
    argv = ["--scene_id", SCENE_ID, "--auto", "--ground", "a chair",
            "--clip_ckpt", os.path.join(ws["base"], "clip_text.npz"),
            "--workspace", ws["port"], "--device", "cpu"]
    with pytest.raises(SystemExit, match="plain-text query needs"):
        tseg_masks.main(argv)


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def guards(ws):
    """One clean subprocess (the test process has imported both
    packages): it imports the stage-2 modules and lists what JAX modules
    came with them, then calls ``seg_masks --ground`` and ``inpaint_rec``
    on the default device and reports what each raised."""
    base = ws["base"]
    r = _run(f"""
        import importlib, json, pkgutil, sys
        import multiview_inpaint_tpu_torch as pkg
        mods = {{m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")}}
        want = {{pkg.__name__ + "." + m for m in {STAGE2!r}}}
        for name in sorted(want):
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "multiview_inpaint_tpu"))
        from multiview_inpaint_tpu_torch.pipelines import (inpaint_rec,
                                                           seg_masks)
        seg = ["--scene_id", "{SCENE_ID}", "--auto", "--ground", "a chair",
               "--clip_ckpt", "{base}/clip_features.npz", "--frames", "1",
               "--iteration", "{ITER}", "--workspace", "{ws['port']}"]
        rec = ["-s", "{base}/dataset/{SCENE}", "-m", "{base}/rec/gpu",
               "--scene_id", "{SCENE_ID}", "--bg_model",
               "{base}/output/{SCENE}", "--workspace", "{ws['port']}",
               "--registry", "{base}/registry.json"]
        raised = []
        for main, argv in ((seg_masks.main, seg), (inpaint_rec.main, rec)):
            try:
                main(argv)
                raised.append(None)
            except Exception as e:
                raised.append(f"{{type(e).__name__}}: {{e}}")
        print(json.dumps({{"missing": sorted(want - mods), "jax": bad,
                          "raised": raised}}))
    """)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_stage2_modules_import_neither_jax_nor_the_jax_package(guards):
    assert guards["missing"] == [] and guards["jax"] == [], guards


def test_stage2_clis_raise_without_a_gpu(guards):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    for raised in guards["raised"]:
        assert raised and raised.startswith("RuntimeError") and (
            "no CUDA device" in raised), guards["raised"]
