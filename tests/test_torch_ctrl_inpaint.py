"""Port parity, the ``ctrl_inpaint`` CLI of the port (``--device cpu``)
against the JAX CLI, on the workspace of ``test_torch_stage2_cli.py``
(``_build``), each package on its own copy, with the depth hint that the
port's ``gen_depth`` renders from the background PLY in both.

Bar:
- ``ctrl_inpaint --tiny`` with both samplers (64x64, 3 steps, one
  sample) from one pair of seeded checkpoints, the port's initial noise
  hooked to JAX's draws and the JAX ``import_controlnet`` monkeypatched
  to map the trunk in the 2D key space (as the port does: unpatched, it
  leaves the trunk's ResBlocks at their init), so that both load the
  same weights: every PNG within 1 uint8 level.

The JAX CLIs init their networks only to learn the leaves' shapes before
loading every leaf from the checkpoints; the test swaps those inits for
``jax.eval_shape`` (the eager inits take ~45 s on one core).
"""

import functools
import os
import shutil

import numpy as np
import jax
import pytest
import torch
from PIL import Image

from multiview_inpaint_tpu.config import registries as jreg
from multiview_inpaint_tpu.diffusion import controlnet2d as jcontrolnet2d
from multiview_inpaint_tpu.diffusion import unet2d as junet2d
from multiview_inpaint_tpu.diffusion import vae as jvae
from multiview_inpaint_tpu.diffusion import weights_io as jweights_io
from multiview_inpaint_tpu.pipelines import ctrl_inpaint as jctrl_inpaint
from multiview_inpaint_tpu_torch.config import registries as treg
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.diffusion.controlnet2d import ControlNet2D
from multiview_inpaint_tpu_torch.diffusion.unet2d import UNet2D
from multiview_inpaint_tpu_torch.diffusion.vae import AutoencoderKL
from multiview_inpaint_tpu_torch.pipelines import ctrl_inpaint as tctrl
from multiview_inpaint_tpu_torch.pipelines import gen_depth as tgen_depth
from test_torch_stage2_cli import (ITER, REGISTRY_DICTS, SCENE, SCENE_ID,
                                   _build)
from test_torch_unet2d import _seeded

CTX = 16


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    saved = [(mod, name, dict(getattr(mod, name)))
             for mod in (jreg, treg) for name in REGISTRY_DICTS]
    base = tmp_path_factory.mktemp("slice7_prior")
    _build(str(base))
    out = {"base": str(base)}
    for name in ("jax", "port"):
        shutil.copytree(base / "ws", base / name)
        out[name] = str(base / name)
    tgen_depth.main([
        "-s", os.path.join(str(base), "dataset", SCENE), "--scene_id",
        SCENE_ID, "--workspace", out["port"], "--resolution", "1",
        "--registry", str(base / "registry.json"), "-m",
        str(base / "output" / SCENE), "--sds_model",
        str(base / "output" / SCENE), "--sds_iteration", str(ITER),
        "--frames", "1", "--modes", "x1", "--device", "cpu"])
    shutil.copytree(base / "port" / "inpaint" / "depth",
                    base / "jax" / "inpaint" / "depth")
    yield out
    for mod, name, d in saved:
        getattr(mod, name).clear()
        getattr(mod, name).update(d)


def _abstract_init(monkeypatch, cls):
    real = cls.init
    monkeypatch.setattr(cls, "init", lambda self, *a, **kw: jax.eval_shape(
        functools.partial(real, self, **kw), *a))


def _ctrl_checkpoints(base):
    """Seeded tiny UNet2D + VAE (one SD file) and ControlNet2D, every leaf
    moved off its init, as torch ``.ckpt`` files in the reference keys."""
    args = type("A", (), {"tiny": True, "context_dim": CTX})
    cfg2d, vae_cfg = tctrl.configs(args)
    torch.manual_seed(0)
    unet = _seeded(UNet2D(cfg2d), 11)
    vae = _seeded(AutoencoderKL(vae_cfg, video_decoder=False), 12)
    cnet = _seeded(ControlNet2D(cfg2d), 13)
    sd = {checkpoint.PREFIXES["unet"] + k: v
          for k, v in unet.state_dict().items()}
    sd.update({checkpoint.PREFIXES["vae"] + k: v
               for k, v in vae.state_dict().items()})
    csd = {checkpoint.PREFIXES["controlnet"] + k: v
           for k, v in cnet.state_dict().items()}
    paths = (os.path.join(base, "sd.ckpt"), os.path.join(base, "ctrl.ckpt"),
             os.path.join(base, "embs.npy"))
    torch.save({"state_dict": sd}, paths[0])
    torch.save({"state_dict": csd}, paths[1])
    np.save(paths[2], np.random.default_rng(14).normal(
        size=(2, 4, CTX)).astype(np.float32))
    return paths


def _import_controlnet_2d(flax_params, state_dict, prefix="control_model."):
    """The JAX ``import_controlnet`` with the trunk mapped through the 2D
    UNet's key space, as the port maps it."""
    mapped = {}
    for k, v in state_dict.items():
        if not k.startswith(prefix):
            continue
        key = k[len(prefix):]
        head = key.split(".")[0]
        if head in ("input_hint_block", "zero_convs", "middle_block_out"):
            *body, leaf = key.split(".")
            mapped[("_".join(body), "kernel" if leaf == "weight"
                    else leaf)] = v
        else:
            mapped[tuple(["trunk"] + jweights_io._map_unet_key(
                key, video=False))] = v
    return jweights_io._merge(flax_params, mapped)


@pytest.mark.parametrize("sampler", ["unipc", "dpmpp2m"])
def test_ctrl_inpaint_tiny_matches_jax(ws, sampler, monkeypatch):
    sd, ctrl, embs = _ctrl_checkpoints(ws["base"])
    for cls in (junet2d.UNet2D, jcontrolnet2d.ControlNet2D,
                jvae.AutoencoderKL):
        _abstract_init(monkeypatch, cls)
    monkeypatch.setattr(jweights_io, "import_controlnet",
                        _import_controlnet_2d)
    draws = []

    def jax_noise(generator, shape, device):
        key = jax.random.key(3)
        for _ in range(len(draws) + 1):
            key, k1 = jax.random.split(key)
        draws.append(shape)
        return torch.from_numpy(np.array(jax.random.normal(k1, shape)))

    monkeypatch.setattr(tctrl, "initial_noise", jax_noise)
    outs = {}
    for name, main, extra in ((
            "jax", jctrl_inpaint.main, []),
            ("port", tctrl.main, ["--device", "cpu"])):
        main(["--scene_id", SCENE_ID, "--workspace", ws[name],
              "--sd_ckpt", sd, "--ctrl_ckpt", ctrl, "--text_embs", embs,
              "--tiny", "--context_dim", str(CTX), "--size", "64",
              "--iteration", str(ITER), "--n_samples", "1", "--num_steps",
              "3", "--sampler", sampler, "--seed", "3"] + extra)
        with Image.open(os.path.join(ws[name], "inpaint", "ctrl", SCENE_ID,
                                     "ctrl_0.png")) as im:
            outs[name] = np.asarray(im).astype(np.int16)
    assert draws == [(1, 8, 8, 4)]
    assert outs["port"].shape == outs["jax"].shape == (64, 64, 3)
    assert outs["jax"].max() > outs["jax"].min()
    assert np.abs(outs["port"] - outs["jax"]).max() <= 1
