"""Port parity, the ``cmp`` CLI (``pipelines/cmp.py``): the JAX and the
port CLI on one synthetic tree, with the same full-width MUSIQ
(``MUSIQConfig()``) and WaDIQaM-NR weights as npz files in the JAX
``save_params`` layout, on the CPU.

The tree is the ``render`` CLI's output layout,
``<root>/{inpainted,src}/<scene>/ours_<iter>/renders``: two inpainted
scenes of 11 frames at 64x64, one of which (``bench_chair``) finds its
source scene (``bench``: ``scene.split("_")[0]``) and one that does not;
``--n_frame 4`` takes every second frame. The weights are the port's
seeded init moved by a seeded N(0, 0.05^2) draw, written by
``musiq.state_dict_to_jax`` / ``checkpoint.torch_to_flax`` and
``checkpoint.save_params``.

Bars: the report's keys, scene by scene and in ``mean``, equal to the JAX
CLI's; sharpness and psnr_vs_src within 1e-6 relative (numpy on the same
PNG pixels); musiq and wadiqam within 1e-4 relative.
"""

import json

import numpy as np
import pytest
import torch

from multiview_inpaint_tpu.pipelines import cmp as jcmp
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.gs import scene_io
from multiview_inpaint_tpu_torch.metrics import musiq as tmusiq
from multiview_inpaint_tpu_torch.metrics import wadiqam as twad
from multiview_inpaint_tpu_torch.pipelines import cmp as tcmp

ITER, FRAMES, SIZE = 7, 11, 64


def _seeded(module, seed, scale=0.05):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen))
    return module


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cmp")
    root = tmp / "vis" / "cmp" / "exp"
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE] / SIZE
    base = np.stack([yy, xx, 0.5 * (yy + xx)], -1)
    for kind, scene, noise in (("src", "bench", 0.0),
                               ("inpainted", "bench_chair", 0.15),
                               ("inpainted", "toy_case", 0.3)):
        rdir = root / kind / scene / f"ours_{ITER}" / "renders"
        for i in range(FRAMES):
            img = np.clip(np.roll(base, 3 * i, axis=1) + noise * rng.normal(
                size=base.shape), 0, 1).astype(np.float32)
            scene_io.save_image(str(rdir / f"{i:05d}.png"), img)
    torch.manual_seed(0)
    musiq = _seeded(tmusiq.MUSIQ(tmusiq.MUSIQConfig()), 1)
    wad = _seeded(twad.WaDIQaMNR(), 2)
    musiq_ckpt, wad_ckpt = str(tmp / "musiq.npz"), str(tmp / "wadiqam.npz")
    checkpoint.save_params(musiq_ckpt, tmusiq.state_dict_to_jax(
        musiq.state_dict(), musiq.cfg.heads))
    checkpoint.save_params(wad_ckpt, checkpoint.torch_to_flax(
        wad.state_dict()))
    out = {}
    for name, cli, extra in (("jax", jcmp, []),
                             ("port", tcmp, ["--device", "cpu"])):
        path = str(tmp / f"{name}.json")
        cli.main(["--root", str(root), "--iteration", str(ITER),
                  "--n_frame", "4", "--out", path, "--musiq_ckpt",
                  musiq_ckpt, "--wadiqam_ckpt", wad_ckpt] + extra)
        with open(path) as f:
            out[name] = json.load(f)
    return out


def test_cmp_report_keys_equal_jax(reports):
    want, got = reports["jax"], reports["port"]
    assert set(got) == set(want) == {"bench_chair", "toy_case", "mean"}
    for scene in want:
        assert set(got[scene]) == set(want[scene]), scene
    assert set(want["bench_chair"]) == {"sharpness", "musiq", "wadiqam",
                                        "psnr_vs_src"}
    assert "psnr_vs_src" not in want["toy_case"]


@pytest.mark.parametrize("key,rel", [("sharpness", 1e-6),
                                     ("psnr_vs_src", 1e-6),
                                     ("musiq", 1e-4), ("wadiqam", 1e-4)])
def test_cmp_scores_match_jax(reports, key, rel):
    want, got = reports["jax"], reports["port"]
    for scene in want:
        if key in want[scene]:
            w, g = want[scene][key], got[scene][key]
            assert np.isfinite(g) and abs(g - w) <= rel * abs(w), \
                (scene, key, g, w)

