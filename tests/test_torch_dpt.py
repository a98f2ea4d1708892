"""Port parity, the DPT depth network of ``gen_depth --dpt_ckpt``:
``models/dpt.py`` against the JAX ``models/dpt.py`` on the CPU in f32.

A tiny DPT (the JAX golden test's: width 32, 4 layers of 2 heads, 16-px
patches on a 64-px grid, necks (8, 12, 16, 16), fusion 16) with seeded
weights in the JAX layout (leaves and shapes from ``jax.eval_shape`` of
the JAX init), carried into the port by ``dpt.state_dict_from_jax``.

Bars:
- the forward at the native grid and at an interpolated position
  embedding (80x48) within 1e-4 of max|JAX|;
- ``import_dpt`` and ``load_dpt_torch`` on a synthetic HF-key state dict
  (the port module's, plus the keys both importers consume and drop):
  the same parameters, bit for bit, as the JAX importer's, the same
  inferred config, and a refusal of an unknown key;
- ``estimate_depth`` on a 40x56 render within 1e-4 of the [0, 1] range
  (JAX's bicubic is off its own float64 evaluation by 1.3e-5);
- the ``gen_depth --dpt_ckpt`` CLI of the port (``--device cpu``) against
  the JAX CLI with that checkpoint on the first x1 orbit frame (512x384)
  of the workspace of ``test_torch_stage2_cli.py`` (``_build``; the
  background PLY as the coarse model): every pixel within 1 uint8 level.
  The JAX loader's eager init, which only gives its importer the leaves'
  shapes, is swapped for ``jax.eval_shape`` (~20 s on one core).
"""

import dataclasses
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from PIL import Image

from multiview_inpaint_tpu.config import registries as jreg
from multiview_inpaint_tpu.models import dpt as jdpt
from multiview_inpaint_tpu.pipelines import gen_depth as jgen_depth
from multiview_inpaint_tpu_torch.config import registries as treg
from multiview_inpaint_tpu_torch.models import dpt as tdpt
from multiview_inpaint_tpu_torch.pipelines import gen_depth as tgen_depth
from test_torch_stage2_cli import (ITER, REGISTRY_DICTS, SCENE, SCENE_ID,
                                   _build)

TINY = dict(hidden_size=32, num_layers=4, num_heads=2, mlp_dim=64,
            patch_size=16, image_size=64, out_indices=(0, 1, 2, 3),
            neck_hidden_sizes=(8, 12, 16, 16), fusion_hidden_size=16)


@pytest.fixture(scope="module")
def pair():
    jcfg = jdpt.DPTConfig(**TINY)
    shapes = jax.eval_shape(jdpt.DPTDepth(jcfg).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    rng = np.random.default_rng(0)
    flat = {"/".join(k): (0.2 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in flatten_dict(shapes).items()}
    model = tdpt.DPTDepth(tdpt.DPTConfig(**TINY))
    model.load_state_dict(tdpt.state_dict_from_jax(flat, model.cfg),
                          strict=True)
    params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                             for k, v in flat.items()})
    return dict(jcfg=jcfg, shapes=shapes, params=params, flat=flat,
                model=model.eval().requires_grad_(False))


@pytest.mark.parametrize("hw", [(64, 64), (80, 48)])
def test_forward_matches_jax(pair, hw):
    x = np.random.default_rng(1).normal(size=(2,) + hw + (3,)).astype(
        np.float32)
    want = np.asarray(jax.jit(jdpt.DPTDepth(pair["jcfg"]).apply)(
        {"params": pair["params"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = pair["model"](torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _hf_state_dict(pair):
    """A ``DPTForDepthEstimation`` state dict: the port's keys and the
    ones both importers consume and drop."""
    sd = {k: v.clone() for k, v in pair["model"].state_dict().items()}
    gen = torch.Generator().manual_seed(2)
    f = TINY["fusion_hidden_size"]
    pre = "neck.fusion_stage.layers.0.residual_layer1."
    for ci in (1, 2):
        sd[f"{pre}convolution{ci}.weight"] = torch.randn(
            (f, f, 3, 3), generator=gen)
        sd[f"{pre}convolution{ci}.bias"] = torch.randn(f, generator=gen)
    sd["dpt.layernorm.weight"] = torch.ones(TINY["hidden_size"])
    sd["dpt.layernorm.bias"] = torch.zeros(TINY["hidden_size"])
    return sd


def _equal_to_jax(model, jparams, cfg):
    flat = {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(jparams).items()}
    want = tdpt.state_dict_from_jax(flat, cfg)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)


def test_import_dpt_matches_jax(pair):
    sd = _hf_state_dict(pair)
    model = tdpt.import_dpt(tdpt.DPTDepth(tdpt.DPTConfig(**TINY)), sd)
    jparams = jdpt.import_dpt(pair["shapes"],
                              {k: v.numpy() for k, v in sd.items()},
                              pair["jcfg"])
    _equal_to_jax(model, jparams, model.cfg)
    sd["neck.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unconsumed"):
        tdpt.import_dpt(tdpt.DPTDepth(tdpt.DPTConfig(**TINY)), sd)


def _abstract_init(monkeypatch):
    real_init = jdpt.DPTDepth.init
    monkeypatch.setattr(jdpt.DPTDepth, "init", lambda self, *a:
                        jax.eval_shape(lambda *b: real_init(self, *b), *a))


def test_load_dpt_torch_matches_jax(pair, tmp_path, monkeypatch):
    path = str(tmp_path / "dpt.pth")
    torch.save({"state_dict": _hf_state_dict(pair)}, path)
    _abstract_init(monkeypatch)
    cfg, model = tdpt.load_dpt_torch(path)
    jcfg, _, jparams = jdpt.load_dpt_torch(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.out_indices == (0, 1, 2, 3) and not model.training
    _equal_to_jax(model, jparams, cfg)


def test_estimate_depth_matches_jax(pair):
    rgb = np.random.default_rng(3).random((40, 56, 3)).astype(np.float32)
    want = jdpt.estimate_depth(jdpt.DPTDepth(pair["jcfg"]), pair["params"],
                               rgb, proc_size=64)
    got = tdpt.estimate_depth(pair["model"], rgb, proc_size=64)
    assert got.shape == want.shape == (40, 56)
    assert got.min() == 0.0 and abs(got.max() - 1.0) < 1e-6
    assert np.abs(got - want).max() <= 1e-4


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    saved = [(mod, name, dict(getattr(mod, name)))
             for mod in (jreg, treg) for name in REGISTRY_DICTS]
    base = tmp_path_factory.mktemp("dpt_cli")
    _build(str(base))
    out = {"base": str(base)}
    for name in ("jax", "port"):
        shutil.copytree(base / "ws", base / name)
        out[name] = str(base / name)
    yield out
    for mod, name, d in saved:
        getattr(mod, name).clear()
        getattr(mod, name).update(d)


def test_gen_depth_dpt_cli_matches_jax(pair, ws, tmp_path, monkeypatch):
    path = str(tmp_path / "dpt.pth")
    torch.save(_hf_state_dict(pair), path)
    _abstract_init(monkeypatch)
    base, pngs = ws["base"], {}
    for name, main, dev in (("jax", jgen_depth.main, ["--backend", "xla"]),
                            ("port", tgen_depth.main, ["--device", "cpu"])):
        main(["-s", os.path.join(base, "dataset", SCENE), "--scene_id",
              SCENE_ID, "--workspace", ws[name], "--resolution", "1",
              "--registry", os.path.join(base, "registry.json"), "-m",
              os.path.join(base, "output", SCENE), "--sds_model",
              os.path.join(base, "output", SCENE), "--sds_iteration",
              str(ITER), "--frames", "1", "--modes", "x1", "--dpt_ckpt",
              path, "--dpt_size", "64"] + dev)
        out = os.path.join(ws[name], "inpaint", "depth", SCENE_ID, "x1")
        assert os.listdir(out) == ["00.png"]
        with Image.open(os.path.join(out, "00.png")) as im:
            pngs[name] = np.asarray(im).astype(np.int16)
    assert pngs["port"].shape == pngs["jax"].shape == (512, 384, 3)
    assert pngs["jax"].max() > pngs["jax"].min()
    assert np.abs(pngs["port"] - pngs["jax"]).max() <= 1
