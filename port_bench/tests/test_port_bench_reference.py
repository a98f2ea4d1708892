"""The frozen references against the program's plain CPU path at tiny
sizes; the controls and the planted faults come out not correct."""

from __future__ import annotations

import pytest
import torch

from port_bench.harness.context import Run
from port_bench.harness.loader import Manifest
from port_bench.tests.conftest import run_cell


def _run(tiny, cell, seed=3000000777):
    m = Manifest(*tiny)
    spec = m.cell(cell)
    return Run(torch, torch.device("cpu"), seed=seed, seconds=0,
               trace=False, config=m.config(spec), traffic=m.traffic(spec),
               cell=spec, t_start=0.0)


def test_svd_reference_is_the_programs_float32_clip(tiny):
    from port_bench.drivers import svd_clip as d
    from port_bench.reference.svd import model as ref_model
    run = _run(tiny, "svd-clip")
    spec = ref_model.weight_spec(run.config)
    eng = d.load_engine(run, run.config, run.traffic, spec)
    with torch.no_grad():
        got = d.program_clip(run, eng, 0, run.traffic["num_steps"])
    want = d.reference_clip(run, spec, 0)
    # float32 on both sides; the attention's products and the blocks of
    # its softmax differ, a few ulp that the steps carry to ~1e-5
    assert d.rel_rms(got, want) < 1e-4


def test_splat_references_are_the_programs_plain_path(tiny):
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import api
    from port_bench.drivers import gs_render, gs_train
    from port_bench.drivers import splat_common as sc
    from port_bench.drivers.train_check import gaps
    from port_bench.inputs import scene as scene_mod
    run = _run(tiny, "gs2m-train-1080p")
    fields, cams, pcams, params = sc.setup(run)
    bg = torch.zeros(3)
    with torch.no_grad():
        out = api.render(params, pcams[0], bg, sh_degree=3, device="cpu")
    g = gs_render.gaps(run, [(0, (out.rgb, out.depth))], cams, fields)
    assert g["rgb_rms"] < 1e-6 and g["depth_rms"] < 1e-5
    targets = gs_train.targets_of(run, fields, cams)
    opt = gs_trainer.OptimizationConfig(**run.config["optimization"])
    extent = scene_mod.camera_extent(cams)
    _, prog = gs_train.program_first_steps(run, fields, pcams, targets, opt,
                                           extent, params)
    want = gs_train.reference_readings(run, fields, cams, targets,
                                       opt.__dict__, extent, 3)
    assert max(gaps(prog, want).values()) < 1e-4


@pytest.mark.parametrize("cell", ["svd-clip", "gs2m-train-1080p",
                                  "gs2m-render-1080p"])
def test_control_fails_the_limits(tiny, cell):
    """The control, put in the program's place, reads over at least one
    of the cell's limits; the driver is found by the traffic's name."""
    run = _run(tiny, cell)
    readings = Manifest(*tiny).driver(run.traffic).calibrate(run)
    limits = run.traffic["limits"]
    assert any(v > limits[k] for k, v in readings["control"].items()
               if k in limits)
    if "half_batch" in readings:
        assert any(v > limits[k] for k, v in readings["half_batch"].items()
                   if k in limits)


def _svd_answer_altered(monkeypatch):
    from multiview_inpaint_tpu_torch.diffusion import engine
    decode = engine.SVDEngine.decode_first_stage
    monkeypatch.setattr(engine.SVDEngine, "decode_first_stage",
                        lambda self, z, timesteps=1:
                        decode(self, z, timesteps) * 0.9)


def _svd_half_batch(monkeypatch):
    """The CFG batch's conditional half left out."""
    from multiview_inpaint_tpu_torch.diffusion import guiders
    monkeypatch.setattr(guiders.LinearPredictionGuider, "combine",
                        lambda self, out, sigma: out.chunk(2, dim=0)[0])


def _train_state_unchanged(monkeypatch):
    from multiview_inpaint_tpu_torch.models import gs_trainer
    monkeypatch.setattr(gs_trainer, "apply_adam",
                        lambda state, *a, **k: (state, torch.zeros(())))


def _train_half_batch(monkeypatch):
    from multiview_inpaint_tpu_torch.models import gs_trainer
    terms = gs_trainer.loss_terms
    monkeypatch.setattr(gs_trainer, "loss_terms",
                        lambda rgb, gt, *a, **k: terms(
                            rgb[:rgb.shape[0] // 2], gt[:gt.shape[0] // 2],
                            *a, **k))


def _render_answer_altered(monkeypatch):
    from multiview_inpaint_tpu_torch.ops.rasterizer import api
    render = api.render

    def altered(*a, **k):
        out = render(*a, **k)
        return out._replace(rgb=out.rgb + 0.01)

    monkeypatch.setattr(api, "render", altered)


@pytest.mark.parametrize("cell,fault", [
    ("svd-clip", _svd_answer_altered), ("svd-clip", _svd_half_batch),
    ("gs2m-train-1080p", _train_state_unchanged),
    ("gs2m-train-1080p", _train_half_batch),
    ("gs2m-render-1080p", _render_answer_altered)])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    """The run with the chip's look skipped and the timed path broken
    underneath: ``correct`` comes out false."""
    fault(monkeypatch)
    rc, line, _ = run_cell(tiny, cell)
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1
