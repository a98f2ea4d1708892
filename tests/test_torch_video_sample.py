"""Port parity, image-to-video serving: ``diffusion/safety`` against the
JAX package's bit for bit, ``divide_test`` against the JAX CLI (numpy and
PIL only), the ``simple_video_sample`` CLI with the tiny model and
always-trigger safety heads, the ``demo_app`` server on port 0, and the
compute type of ``simple_video_sample``'s uncontrolled UNet.

The JAX CLI's denoiser applies the UNet to f32 latents with the stored
(``--param_dtype``, bf16) weights and no cast; flax promotes bf16 weights
and f32 inputs to f32, so the UNet computes in f32 on bf16-rounded
weights. The port's engine holds that UNet in f32 with the values rounded
through bf16. One tiny-UNet evaluation with bf16-stored weights holds the
port against JAX's denoiser (taken out of ``sample_clip`` as it is built
there) at 1e-4 of the largest magnitude (f32 sums in another order), and
the same UNet computing in bf16 misses JAX by more than 10 times that.
"""

import argparse
import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from multiview_inpaint_tpu.diffusion import engine as jengine
from multiview_inpaint_tpu.diffusion import safety as jsafety
from multiview_inpaint_tpu.diffusion import samplers as jsamplers
from multiview_inpaint_tpu.pipelines import divide_test as jdivide
from multiview_inpaint_tpu.pipelines import simple_video_sample as jsvs
from multiview_inpaint_tpu.pipelines import svd_test as jsvd_test
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.diffusion import engine as tengine
from multiview_inpaint_tpu_torch.diffusion import safety as tsafety
from multiview_inpaint_tpu_torch.gs import scene_io
from multiview_inpaint_tpu_torch.pipelines import demo_app, divide_test
from multiview_inpaint_tpu_torch.pipelines import simple_video_sample as svs
from multiview_inpaint_tpu_torch.pipelines import svd_test


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: PyTorch's default threads on the tiny
    networks' many small ops thrash a machine the tests share with
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

T, SIZE = 3, (64, 48)
LAT = (T, SIZE[0] // 8, SIZE[1] // 8, 4)


# --- safety -----------------------------------------------------------------

def _embed(img):
    v = np.asarray(img, np.float64).reshape(-1)[:32]
    return v * np.linspace(-1, 2, 32)


@pytest.mark.parametrize("nsfw,watermark", [(-3.0, -4.0), (40.0, -40.0),
                                            (-40.0, 40.0), (0.3, 0.0)])
def test_safety_filter_matches_jax_bit_for_bit(nsfw, watermark):
    rng = np.random.default_rng(1)
    heads = {"nsfw": np.concatenate([rng.normal(size=32), [nsfw]]),
             "watermark": np.concatenate([rng.normal(size=32), [watermark]])}
    img = rng.uniform(-1, 1, (20, 14, 3)).astype(np.float32)
    got = tsafety.SafetyFilter(_embed, heads, 0.4, 0.6)
    want = jsafety.SafetyFilter(_embed, heads, 0.4, 0.6)
    assert got.scores(img) == want.scores(img)
    np.testing.assert_array_equal(got(img), want(img))
    np.testing.assert_array_equal(tsafety._box_blur(img, 5),
                                  jsafety._box_blur(img, 5))
    assert tsafety.SafetyFilter().scores(img) == \
        jsafety.SafetyFilter().scores(img) == {"nsfw": 0.0, "watermark": 0.0}


def test_load_heads_matches_jax(tmp_path):
    path = str(tmp_path / "heads.npz")
    np.savez(path, nsfw=np.arange(5.0), watermark=-np.arange(5.0))
    got, want = tsafety.load_heads(path), jsafety.load_heads(path)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# --- divide_test ---------------------------------------------------------

def test_divide_test_matches_the_jax_cli(tmp_path):
    """Two 4x4 grids (x1 and x2 of one case) split by both CLIs: the same
    PNGs, byte for byte, and the same preview GIF frames (x1 reversed
    without its first frame, then x2)."""
    frames_hw = (16, 12)
    grid_dir = tmp_path / "grids"
    rng = np.random.default_rng(2)
    for i in range(2):
        frames = rng.uniform(-1, 1, (T,) + frames_hw + (3,)).astype(
            np.float32)
        scene_io.save_image(
            str(grid_dir / f"samples_gs-{i:06d}_e-000000_b-{i:06d}.png"),
            svd_test.to_grid(frames))
    items = ["toy_case:ctrl_0:x1", "toy_case:ctrl_0:x2"]
    outs = {}
    for name, cli in (("port", divide_test), ("jax", jdivide)):
        out = str(tmp_path / name)
        cli.main(["--grid_dir", str(grid_dir), "--out", out, "--items",
                  *items, "--frame_size", *map(str, frames_hw),
                  "--num_frames", str(T)])
        outs[name] = out
    for mode in ("x1", "x2"):
        rel = os.path.join("toy_case", "ctrl_0", mode)
        names = sorted(os.listdir(os.path.join(outs["port"], rel)))
        assert names == [f"{i:02d}.png" for i in range(T)]
        assert names == sorted(os.listdir(os.path.join(outs["jax"], rel)))
        for f in names:
            with open(os.path.join(outs["port"], rel, f), "rb") as a, \
                    open(os.path.join(outs["jax"], rel, f), "rb") as b:
                assert a.read() == b.read(), f
    gifs = [os.path.join(outs[k], "vis_video", "toy_case", "ctrl_0.gif")
            for k in ("port", "jax")]
    seqs = []
    for g in gifs:
        with Image.open(g) as im:
            seqs.append([np.asarray(f.convert("RGB"))
                         for f in ImageSequence.Iterator(im)])
    assert len(seqs[0]) == len(seqs[1]) == 2 * T - 1
    for a, b in zip(*seqs):
        np.testing.assert_array_equal(a, b)


# --- simple_video_sample and the demo server ---------------------------------

def _image(path, seed=3):
    rng = np.random.default_rng(seed)
    scene_io.save_image(path, rng.uniform(0, 1, SIZE + (3,)))
    return path


def test_simple_video_sample_cli_with_safety_heads(tmp_path, capsys):
    """The tiny model on the CPU with always-trigger probes (a huge
    positive nsfw bias): the CLIP-embed -> probe -> blur path end to end,
    every frame blurred, frames and GIF written."""
    heads = str(tmp_path / "heads.npz")
    d = 16   # the tiny model's CLIP output_dim
    np.savez(heads, nsfw=np.concatenate([np.zeros(d), [100.0]]),
             watermark=np.concatenate([np.zeros(d), [-100.0]]))
    out = str(tmp_path / "vid")
    svs.main(["--image", _image(str(tmp_path / "in.png")), "--out", out,
              "--tiny_model", "--num_frames", str(T), "--num_steps", "2",
              "--size", str(SIZE[0]), str(SIZE[1]), "--safety_heads", heads,
              "--device", "cpu"])
    assert f"safety filter blurred {T}/{T} frames" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == [f"{i:02d}.png" for i in range(T)] + [
        "video.gif"]
    img = scene_io.load_image(os.path.join(out, "00.png"))
    assert img.shape == SIZE + (3,) and np.isfinite(img).all()


def _request(url, data=None):
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=data, method="POST" if data else "GET"),
                timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_demo_app_serves_health_page_and_generate(tmp_path, monkeypatch):
    """The server on port 0 with the tiny model on the CPU: /health, the
    page, one POST /generate answered with a GIF of num_frames frames, a
    num_frames mismatch answered with 500, the model loaded once."""
    loads = []
    load_model = svs.load_model
    monkeypatch.setattr(svs, "load_model", lambda a: loads.append(1) or
                        load_model(a))
    monkeypatch.setattr(demo_app, "_MODEL", {})
    args = demo_app.build_parser().parse_args([
        "--port", "0", "--tiny_model", "--num_frames", str(T),
        "--num_steps", "2", "--size", str(SIZE[0]), str(SIZE[1]),
        "--device", "cpu"])
    srv = demo_app.make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, ctype, body = _request(base + "/health")
        assert code == 200 and json.loads(body)["model"] == "tiny"
        code, ctype, body = _request(base + "/")
        assert code == 200 and ctype == "text/html" and b"Generate" in body
        with open(_image(str(tmp_path / "in.png")), "rb") as f:
            png = f.read()
        code, ctype, body = _request(base + "/generate?seed=5", png)
        assert code == 200 and ctype == "image/gif", body[:200]
        gif = str(tmp_path / "out.gif")
        with open(gif, "wb") as f:
            f.write(body)
        with Image.open(gif) as im:
            assert im.n_frames == T and im.size == (SIZE[1], SIZE[0])
        code, _, body = _request(base + "/generate?num_frames=5", png)
        assert code == 500 and b"num_frames" in body
        assert len(loads) == 1
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


# --- the uncontrolled UNet's compute type ------------------------------------

class _Captured(Exception):
    pass


def _tiny_args():
    return argparse.Namespace(tiny_model=True, num_frames=T, num_steps=2)


def test_uncontrolled_unet_computes_in_f32_on_bf16_weights(tmp_path,
                                                           monkeypatch):
    """One evaluation of the uncontrolled denoiser with bf16-stored UNet
    weights: the port's (UNet held in f32, the values rounded through
    bf16) against JAX's, taken out of ``sample_clip`` with the JAX UNet's
    leaves stored in bf16; the same UNet computing in bf16 misses JAX by
    more than 10 times the bar."""
    cfg = svs._engine_config(_tiny_args())
    f32 = tengine.init_engine(cfg, device="cpu")
    gen = torch.Generator().manual_seed(70)
    with torch.no_grad():
        for p in f32.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    sd = {k: v.to(torch.bfloat16).float()
          for k, v in f32.reference_state_dict().items()}
    engines = {}
    for name, compute in (("f32", "float32"), ("bf16", "bfloat16")):
        eng = tengine.init_engine(dataclasses.replace(
            cfg, compute_dtype=compute), device="cpu",
            param_dtype=torch.bfloat16)
        eng.load_reference_state_dict(sd)
        engines[name] = eng
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        assert engines[name].unet.input_blocks[0][0].weight.dtype == dt
    flat = checkpoint.state_dict_to_jax(sd, "unet")
    unet = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        d = unet
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v, jnp.bfloat16)
    jcfg = jsvd_test._engine_config(argparse.Namespace(
        tiny_model=True, num_frames=T, num_steps=2))
    jeng = jengine.SVDEngine(jcfg)
    state = jengine.EngineState(unet=unet, controlnet={}, vae={}, clip={})
    rng = np.random.default_rng(71)
    cond = {"crossattn": rng.normal(size=(1, 1, 16)),
            "vector": rng.normal(size=(1, 768)),
            "concat": rng.normal(size=(1,) + LAT[1:])}
    cond = {k: v.astype(np.float32) for k, v in cond.items()}

    class Conditioner:
        def __call__(self, batch, force_zero=False, key=None):
            return {k: jnp.asarray(v) for k, v in cond.items()}

    captured = {}

    def capture(denoise, x, c, uc, sigmas, **kw):
        captured.update(denoise=denoise, c=c)
        raise _Captured

    monkeypatch.setattr(jeng, "conditioner", lambda st: Conditioner())
    monkeypatch.setattr(jsamplers, "euler_edm_sample", capture)
    args = jsvs.build_parser().parse_args([
        "--image", _image(str(tmp_path / "in.png")), "--num_frames", str(T),
        "--size", str(SIZE[0]), str(SIZE[1]), "--out", str(tmp_path / "o")])
    with pytest.raises(_Captured):
        jsvs.sample_clip(jeng, state, jcfg, args)
    x = rng.normal(size=LAT).astype(np.float32) * 4
    sig = np.array([0.3, 2.0, 30.0], np.float32)
    want = np.asarray(jax.jit(lambda xx, ss: captured["denoise"](
        xx, ss, captured["c"]))(jnp.asarray(x), jnp.asarray(sig)))
    assert want.dtype == np.float32
    tc = {k: torch.from_numpy(np.array(v)) for k, v in captured["c"].items()}
    errs = {}
    for name, eng in engines.items():
        with torch.no_grad():
            got = svs.uncontrolled_denoise_fn(eng, cfg)(
                torch.from_numpy(x), torch.from_numpy(sig), tc)
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        errs[name] = float(np.abs(got.numpy() - want).max())
    bar = 1e-4 * float(np.abs(want).max())
    assert errs["f32"] <= bar and errs["bf16"] > 10 * bar, (errs, bar)
