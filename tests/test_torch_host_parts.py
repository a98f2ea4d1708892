"""Port parity, the host-side parts: ``utils/live_view`` (the browser live
view of ``train_gs --live_view``), ``data/native_io`` (the ctypes loader
of ``native/dataio.cpp``, and ``gs/scene_io.load_image`` through it) and
``utils/logging``'s wandb mirror, against the JAX modules on the CPU.

Bars: every answer of the live-view servers byte for byte equal for the
same published frame and posted pose; decoded PNGs exactly equal to the
JAX decoder's and PIL's; the wandb stub receiving the same calls from
both loggers (the elapsed-time field aside).
"""

import json
import os
import sys
import types
import urllib.request

import numpy as np
import pytest

from multiview_inpaint_tpu.data import native_io as jnative
from multiview_inpaint_tpu.gs import scene_io as jscene_io
from multiview_inpaint_tpu.utils import live_view as jlive
from multiview_inpaint_tpu.utils import logging as jlogging
from multiview_inpaint_tpu_torch.data import native_io as tnative
from multiview_inpaint_tpu_torch.gs import scene_io as tscene_io
from multiview_inpaint_tpu_torch.pipelines import train_gs
from multiview_inpaint_tpu_torch.utils import live_view as tlive
from multiview_inpaint_tpu_torch.utils import logging as tlogging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _exchange(port):
    """Every request of one round trip: (status, content type, body)."""
    base = f"http://127.0.0.1:{port}"

    def call(path, data=None):
        req = urllib.request.Request(base + path, data=data)
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()

    return [call("/"), call("/pose"), call("/frame.png"),
            call("/pose", json.dumps({"yaw": 30, "pitch": -10,
                                      "radius": 1.5}).encode()),
            call("/pose"), call("/frame.png?123")]


def test_live_view_round_trip_matches_jax():
    frame = np.random.default_rng(0).random((24, 40, 3)).astype(np.float32)
    servers = [jlive.LiveViewServer(0), tlive.LiveViewServer(0)]
    try:
        for s in servers:
            s.publish(frame)
        answers = [_exchange(s._server.server_address[1]) for s in servers]
        assert servers[1].port == servers[1]._server.server_address[1] > 0
        assert servers[1].requested_pose() == servers[0].requested_pose() \
            == {"yaw": 30, "pitch": -10, "radius": 1.5}
    finally:
        for s in servers:
            s.close()
    assert answers[0] == answers[1]
    status, kind, png = answers[1][2]
    assert (status, kind) == (200, "image/png") and png[:4] == b"\x89PNG"


def test_live_camera_matches_the_jax_cli_pose():
    from multiview_inpaint_tpu_torch.gs.cameras import make_camera

    cam = make_camera(0, np.eye(3), np.array([0.0, 0, 4.0]), fovx=0.8,
                      fovy=0.6, width=40, height=24)
    view = train_gs.live_camera(cam, {"yaw": 30, "pitch": -10,
                                      "radius": 1.5}, 2.0)
    # the JAX CLI's pose (train_gs.py:106-118) in float64
    yaw, pitch, r = np.radians(30), np.radians(-10), 3.0
    c = np.array([r * np.cos(pitch) * np.sin(yaw), r * np.sin(pitch),
                  -r * np.cos(pitch) * np.cos(yaw)])
    np.testing.assert_allclose(view.camera_center, c, atol=1e-5)
    z = view.camera_to_world[:3, 2]
    np.testing.assert_allclose(z, -c / np.linalg.norm(c), atol=1e-6)
    assert (view.width, view.height, view.fovx) == (40, 24, 0.8)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(1)
    paths = []
    for i, shape in enumerate([(33, 47, 3), (20, 31), (64, 48, 3)]):
        p = str(root / f"{i}.png")
        tscene_io.save_image(p, rng.random(shape).astype(np.float32))
        paths.append(p)
    return paths


def test_native_decode_matches_jax_and_pil(pngs, tmp_path):
    from PIL import Image

    before = sorted(os.listdir(os.path.join(REPO, "native")))
    build = tmp_path / "build" / "native"
    assert tnative.native_available(build)
    assert tnative.lib_path(build).exists()
    assert jnative.native_available()
    for p in pngs:
        got = tnative.decode_png(p, build)
        with Image.open(p) as im:
            want = np.asarray(im.convert("RGB"))
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jnative.decode_png(p))
    with tnative.PrefetchLoader(n_threads=2, build_dir=build) as loader:
        jobs = [loader.submit(p) for p in pngs]
        for job, p in reversed(list(zip(jobs, pngs))):
            np.testing.assert_array_equal(loader.take(job),
                                          jnative.decode_png(p))
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before


def test_load_image_matches_jax(pngs):
    assert tnative.native_available()
    for p in pngs:
        for gray in (False, True):
            for res in (None, (16, 12)):
                np.testing.assert_array_equal(
                    tscene_io.load_image(p, res, grayscale=gray),
                    jscene_io.load_image(p, res, grayscale=gray))


def test_prefetch_loader_falls_back_to_pil(pngs, tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "missing.cpp")
    build = tmp_path / "nowhere"
    with tnative.PrefetchLoader(build_dir=build) as loader:
        jobs = [loader.submit(p) for p in pngs]
        for job, p in zip(jobs, pngs):
            np.testing.assert_array_equal(loader.take(job),
                                          jnative.decode_png(p))


class _Stub:
    """A ``wandb`` stand-in that records every call."""

    def __init__(self, calls):
        self.calls = calls

    def init(self, **kw):
        self.calls.append(("init", kw))
        return self

    def log(self, row, step=None):
        row = {k: v for k, v in row.items() if k != "t"}
        self.calls.append(("log", row, step))

    def finish(self):
        self.calls.append(("finish",))


def _drive(module, path):
    log = module.RunLogger(path, "svd_train", backend="wandb",
                           wandb_project="proj", config={"lr": 0.1})
    log.log(1, loss=0.5, l1=np.float32(0.25))
    log.log(-1, event="final_ema_eval", loss_raw=1.0)
    log.close()
    with open(log.path) as f:
        return [json.loads(line) for line in f]


def test_wandb_mirror_matches_jax(tmp_path, monkeypatch, capsys):
    calls = {}
    for name, module in (("jax", jlogging), ("torch", tlogging)):
        calls[name] = []
        stub = types.ModuleType("wandb")
        rec = _Stub(calls[name])
        stub.init, stub.log, stub.finish = rec.init, rec.log, rec.finish
        monkeypatch.setitem(sys.modules, "wandb", stub)
        rows = _drive(module, str(tmp_path / "run"))
        assert [r["step"] for r in rows] == [1, -1]
        # both loggers see the same run directory name
        os.rename(tmp_path / "run", tmp_path / f"done_{name}")
    assert calls["jax"] == calls["torch"]
    assert [c[0] for c in calls["torch"]] == ["init", "log", "log", "finish"]

    monkeypatch.setitem(sys.modules, "wandb", None)   # no package
    capsys.readouterr()
    rows = _drive(tlogging, str(tmp_path / "plain"))
    out = capsys.readouterr().out
    assert out.count("wandb unavailable") == 1
    assert rows[0]["loss"] == 0.5 and rows[1]["event"] == "final_ema_eval"
