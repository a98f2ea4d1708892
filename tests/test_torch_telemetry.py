"""The port's spans and counters (``multiview_inpaint_tpu_torch.telemetry``)
on the CPU: off and on, nesting and self times, the profiler's clock, the
spans of the train step, the render and the SVD sampler, the launch
counters that ``kernels.LAUNCHES`` shows, and the spans files of
``train_gs --profile_dir`` and ``svd_test --profile_dir``.
"""

import argparse
import json
import os
import time

import numpy as np
import pytest
import torch

from multiview_inpaint_tpu_torch import kernels, telemetry
from multiview_inpaint_tpu_torch.gs import cameras, gaussians
from multiview_inpaint_tpu_torch.models import gs_trainer
from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera, render

BG = [0.1, 0.2, 0.3]
RENDER_PARTS = ["render.project", "render.bin", "render.gather",
                "render.composite"]
# The spans of a render's host waits: the pair total and active count,
# the tile histogram.
HOST_READS = ["render.bin", "render.bin"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small ops on one intra-op thread, as the other CPU
    files of the port run them when several test workers share cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def _scene(n=300, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.5, 1.5, size=(n, 3))
    xyz[:, 2] = rng.uniform(-1.0, 3.0, size=n)
    return gaussians.from_arrays(
        xyz.astype(np.float32),
        rng.normal(size=(n, 1, 3)).astype(np.float32),
        np.zeros((n, 0, 3), np.float32),
        rng.normal(size=(n, 1)).astype(np.float32),
        np.log(rng.uniform(0.02, 0.15, size=(n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32), device="cpu")


def _camera():
    return RenderCamera.from_camera(
        cameras.make_camera(0, np.eye(3), np.array([0.0, 0, 4.0]),
                            fovx=0.8, fovy=0.7, width=64, height=48), "cpu")


def _children(recs, i):
    return [r["name"] for r in recs if r["parent"] == i]


def test_off_records_nothing_and_shares_one_null_context():
    a, b = telemetry.span("a"), telemetry.span("b")
    assert a is b is telemetry.host_read()
    with a:
        with telemetry.span("c"):
            pass
    assert telemetry.records() == []
    snap = telemetry.snapshot()
    assert snap["spans"] == {} and snap["units"] == 0
    assert snap["dropped"] == 0


def test_nesting_gives_parents_units_and_self_times():
    telemetry.enable()
    with telemetry.span("a"):
        time.sleep(0.002)
        with telemetry.span("b"):
            time.sleep(0.002)
            with telemetry.host_read():
                time.sleep(0.001)
        with telemetry.span("c"):
            pass
    with telemetry.span("a"):
        pass
    telemetry.disable()
    with telemetry.span("after"):
        pass
    recs = telemetry.records()
    assert [r["name"] for r in recs] == ["a", "b", "host_read", "c", "a"]
    assert [r["parent"] for r in recs] == [-1, 0, 1, 0, -1]
    assert [r["unit"] for r in recs] == [1, 1, 1, 1, 2]
    assert all(r["end_ns"] >= r["start_ns"] > 0 for r in recs)
    assert all(r["device_ms"] is None for r in recs)

    def ms(r):
        return (r["end_ns"] - r["start_ns"]) * 1e-6

    snap = telemetry.snapshot()
    s = snap["spans"]
    assert snap["units"] == 2
    assert s["a"]["count"] == 2
    assert s["a"]["host_ms"] == pytest.approx(ms(recs[0]) + ms(recs[4]))
    assert s["a"]["self_host_ms"] == pytest.approx(
        ms(recs[0]) - ms(recs[1]) - ms(recs[3]) + ms(recs[4]))
    assert s["b"]["self_host_ms"] == pytest.approx(ms(recs[1])
                                                   - ms(recs[2]))
    assert s["a"]["read_ms"] == s["b"]["read_ms"] == pytest.approx(
        ms(recs[2])) and ms(recs[2]) >= 1.0
    assert s["c"]["read_ms"] == 0.0
    assert s["a"]["self_host_ms"] >= 2.0
    assert s["a"]["device_ms"] is None


def test_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(telemetry, "MAX_RECORDS", 2)
    telemetry.enable()
    with telemetry.span("a"):
        with telemetry.span("b"):
            with telemetry.span("c"):
                pass
    snap = telemetry.snapshot()
    assert [r["name"] for r in telemetry.records()] == ["a", "b"]
    assert snap["dropped"] == 1 and "c" not in snap["spans"]
    telemetry.reset()
    assert telemetry.snapshot()["dropped"] == 0


def test_device_events_need_a_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            telemetry.enable(device_events=True)
        assert telemetry.span("d") is telemetry.span("e")
        return
    telemetry.enable(device_events=True)
    with telemetry.span("d"):
        torch.ones(1 << 20, device="cuda").sum()
    assert telemetry.snapshot()["spans"]["d"]["device_ms"] > 0


def test_span_starts_on_the_profilers_clock():
    """An enabled span enters ``record_function`` under a profiler session,
    and its start agrees with that event's within 1 ms; a span off, or
    outside a session, leaves no event."""
    from torch.profiler import ProfilerActivity, profile
    with telemetry.span("t.off"):
        pass
    telemetry.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("t.clock"):
            time.sleep(0.002)
    with telemetry.span("t.after"):
        pass
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert "t.off" not in events and "t.after" not in events
    rec = next(r for r in telemetry.records() if r["name"] == "t.clock")
    assert abs(events["t.clock"].start_ns() - rec["start_ns"]) < 1_000_000
    assert abs(events["t.clock"].duration_ns()
               - (rec["end_ns"] - rec["start_ns"])) < 1_000_000


def test_train_step_gives_one_step_with_its_layers():
    p = _scene()
    state = gs_trainer.init_state(p)
    gt = torch.rand(48, 64, 3, generator=torch.Generator().manual_seed(1))
    telemetry.enable()
    state, m = gs_trainer.train_step(state, _camera(), gt, BG,
                                     gs_trainer.OptimizationConfig(), 1.0)
    recs = telemetry.records()
    roots = [i for i, r in enumerate(recs) if r["parent"] == -1]
    assert [recs[i]["name"] for i in roots] == ["trainer.step"]
    assert _children(recs, roots[0]) == ["render", "trainer.loss",
                                         "trainer.backward", "trainer.adam"]
    r = _children(recs, roots[0]).index("render") + 1
    assert _children(recs, r) == RENDER_PARTS
    reads = [x for x in recs if x["name"] == "host_read"]
    assert [recs[x["parent"]]["name"] for x in reads] == HOST_READS
    assert {x["unit"] for x in recs} == {1}
    snap = telemetry.snapshot()
    assert snap["counters"]["render.pairs"] == m.pairs > 0
    step = snap["spans"]["trainer.step"]
    assert step["read_ms"] == snap["spans"]["host_read"]["host_ms"]


def test_render_gives_its_layers_and_counts_pairs():
    telemetry.enable()
    with torch.no_grad():
        out = render(_scene(), _camera(), BG, device="cpu")
        out2 = render(_scene(seed=1), _camera(), BG, device="cpu")
    recs = telemetry.records()
    roots = [i for i, r in enumerate(recs) if r["parent"] == -1]
    assert [recs[i]["name"] for i in roots] == ["render", "render"]
    assert _children(recs, roots[0]) == RENDER_PARTS
    reads = [x for x in recs[:roots[1]] if x["name"] == "host_read"]
    assert [recs[x["parent"]]["name"] for x in reads] == HOST_READS
    assert [r["unit"] for r in recs if r["name"] == "render"] == [1, 2]
    snap = telemetry.snapshot()
    assert snap["counters"]["render.pairs"] == out.pairs + out2.pairs
    assert snap["spans"]["render"]["count"] == 2
    assert snap["spans"]["host_read"]["count"] == 2 * len(HOST_READS)


def test_sample_gives_one_eval_per_step():
    """A tiny engine's clip: the conditioning of c and uc, n Euler steps
    (one ``engine.eval`` each, the ladder read once) and the decode."""
    from multiview_inpaint_tpu_torch.diffusion import engine
    from multiview_inpaint_tpu_torch.pipelines import svd_test
    steps, t = 3, 2
    cfg = svd_test._engine_config(argparse.Namespace(
        tiny_model=True, num_frames=t, num_steps=steps))
    eng = engine.init_engine(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    frame = torch.as_tensor(rng.uniform(-1, 1, (1, 64, 48, 3)),
                            dtype=torch.float32)
    batch = {"cond_frames_without_noise": frame, "cond_frames": frame,
             "fps_id": torch.tensor([6.0]),
             "motion_bucket_id": torch.tensor([127.0]),
             "cond_aug": torch.tensor([0.0]),
             "control_hint": torch.as_tensor(
                 rng.uniform(0, 1, (t, 64, 48, 7)), dtype=torch.float32)}
    telemetry.enable()
    with torch.no_grad():
        c = eng.prepare_cond(batch)
        uc = eng.prepare_cond(batch, unconditional=True)
        z = eng.sample(c, uc, latent_shape=(t, 8, 6, 4),
                       generator=torch.Generator().manual_seed(3))
        eng.decode_first_stage(z, timesteps=t)
    recs = telemetry.records()
    roots = [r["name"] for r in recs if r["parent"] == -1]
    assert roots == (["engine.cond"] * 2 + ["host_read"]
                     + ["engine.eval"] * steps + ["engine.decode"])
    snap = telemetry.snapshot()
    assert snap["spans"]["engine.eval"]["count"] == steps
    assert snap["spans"]["engine.eval"]["read_ms"] == 0.0
    assert snap["units"] == len(roots)


def test_sds_step_gives_its_layers():
    """A tiny SDS step: one ``sds.step`` holding the render, the two
    encodes, one CFG evaluation (counted), the backward and Adam."""
    from multiview_inpaint_tpu_torch.diffusion.unet2d import (UNet2D,
                                                              UNet2DConfig)
    from multiview_inpaint_tpu_torch.diffusion.vae import (AutoencoderKL,
                                                           VAEConfig)
    from multiview_inpaint_tpu_torch.models import sds_trainer
    from multiview_inpaint_tpu_torch.pipelines.sds_train import make_guidance
    torch.manual_seed(0)
    guidance = make_guidance(
        UNet2D(UNet2DConfig(model_channels=32, num_res_blocks=1,
                            attention_resolutions=(1,), channel_mult=(1, 2),
                            num_head_channels=16, context_dim=16)),
        AutoencoderKL(VAEConfig(ch=16, num_res_blocks=1),
                      video_decoder=False), 100.0)
    g = torch.Generator().manual_seed(4)
    gt = torch.rand(48, 64, 3, generator=g)
    mask = torch.zeros(48, 64)
    mask[12:36, 16:48] = 1.0
    state = gs_trainer.init_state(_scene())
    telemetry.enable()
    state, m = sds_trainer.sds_train_step(
        state, _camera(), gt, mask, BG, gs_trainer.INPAINT_OPT, guidance,
        torch.randn(2, 5, 16, generator=g), sds_size=32, generator=g)
    recs = telemetry.records()
    roots = [i for i, r in enumerate(recs) if r["parent"] == -1]
    assert [recs[i]["name"] for i in roots] == ["sds.step"]
    # a host read on the first step alone: the schedule's copy to the
    # device
    assert _children(recs, roots[0]) == [
        "render", "sds.encode", "sds.encode", "host_read", "sds.prior",
        "sds.backward", "sds.adam"]
    adam = next(i for i, r in enumerate(recs) if r["name"] == "sds.adam")
    assert _children(recs, adam) == ["trainer.adam"]
    snap = telemetry.snapshot()
    counts = {k: v["count"] for k, v in snap["spans"].items()}
    assert {k: counts[k] for k in ("sds.step", "sds.encode", "sds.prior",
                                   "sds.backward", "sds.adam")} == {
        "sds.step": 1, "sds.encode": 2, "sds.prior": 1, "sds.backward": 1,
        "sds.adam": 1}
    assert snap["counters"]["sds.prior_evals"] == 1
    assert snap["units"] == 1
    assert torch.isfinite(m.loss) and float(m.sds_loss) > 0


def test_launches_are_the_launch_counters():
    assert kernels.LAUNCHES is telemetry.LAUNCHES
    assert dict(kernels.LAUNCHES) == dict.fromkeys(
        ("pair_expand", "composite", "composite_bwd", "flash_attn_fwd",
         "flash_attn_bwd", "project", "project_bwd"), 0)
    telemetry.count("launch.composite", 2)
    kernels.LAUNCHES["flash_attn_fwd"] += 1
    assert kernels.LAUNCHES["composite"] == 2
    counters = telemetry.snapshot()["counters"]
    assert counters["launch.flash_attn_fwd"] == 1
    assert sum(kernels.LAUNCHES.values()) == 3
    saved = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    assert sum(kernels.LAUNCHES.values()) == 0
    kernels.LAUNCHES.update(saved)
    assert kernels.LAUNCHES["composite"] == 2
    telemetry.count("render.pairs", 5)
    kernels.reset_launches()
    assert telemetry.snapshot()["counters"]["render.pairs"] == 5


def test_train_gs_profile_dir_writes_the_spans(tmp_path):
    from multiview_inpaint_tpu_torch.pipelines import train_gs
    from multiview_inpaint_tpu_torch.utils import synthetic
    src = str(tmp_path / "dataset" / "toy")
    synthetic.make_colmap_scene(src, n_views=3, width=32, height=24,
                                n_points=120, device="cpu")
    model, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    last = train_gs.PROFILE_TO + 1
    train_gs.main([
        "-s", src, "-m", model, "--resolution", "1",
        "--iterations", str(last), "--densify_until_iter", "0",
        "--test_iterations", str(last), "--save_iterations", str(last),
        "--log_interval", "1000", "--profile_dir", prof,
        "--device", "cpu"])
    assert telemetry.span("a") is telemetry.span("b")      # off again
    with open(os.path.join(prof, "spans.json")) as f:
        spans = json.load(f)
    n = train_gs.PROFILE_TO - train_gs.PROFILE_FROM
    snap = spans["snapshot"]
    assert snap["spans"]["trainer.step"]["count"] == n
    assert snap["spans"]["render"]["count"] == n
    assert snap["units"] == n and snap["dropped"] == 0
    steps = [r for r in spans["records"] if r["name"] == "trainer.step"]
    assert [r["unit"] for r in steps] == list(range(1, n + 1))
    with open(os.path.join(prof, "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"trainer.step", "render.project", "host_read"} <= names


def test_svd_test_profile_dir_writes_the_last_items_spans(tmp_path):
    """Two items (modes x1, x2): the second is profiled, with its own
    conditioning of c and uc, one ``engine.eval`` a step and the decode."""
    from multiview_inpaint_tpu_torch.pipelines import svd_test
    from multiview_inpaint_tpu_torch.utils import synthetic
    t, steps, size = 2, 3, (64, 48)
    root, prof = str(tmp_path / "gs"), str(tmp_path / "prof")
    synthetic.write_gs_tree(root, scene="toy", ctrl="ctrl_0",
                            modes=("x1", "x2"), frames=t, size=size,
                            iteration=40)
    svd_test.main(["--data_root", root, "--logdir", str(tmp_path / "logs"),
                   "--tiny_model", "--num_frames", str(t), "--num_steps",
                   str(steps), "--size", str(size[0]), str(size[1]),
                   "--iteration", "40", "--profile_dir", prof,
                   "--device", "cpu"])
    assert telemetry.span("a") is telemetry.span("b")      # off again
    with open(os.path.join(prof, "spans.json")) as f:
        spans = json.load(f)
    snap = spans["snapshot"]
    counts = {k: v["count"] for k, v in snap["spans"].items()}
    # host reads: the CLIP tower's mean and std copies in each
    # conditioning, the ladder once
    assert counts == {"engine.cond": 2, "engine.eval": steps,
                      "engine.decode": 1, "host_read": 3}
    assert snap["dropped"] == 0
    recs = spans["records"]
    assert [recs[r["parent"]]["name"] if r["parent"] >= 0 else None
            for r in recs if r["name"] == "host_read"] == [
        "engine.cond", "engine.cond", None]
    roots = [r["name"] for r in recs if r["parent"] == -1]
    assert roots == (["engine.cond"] * 2 + ["host_read"]
                     + ["engine.eval"] * steps + ["engine.decode"])
    with open(os.path.join(prof, "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"engine.cond", "engine.eval", "engine.decode"} <= names
