"""The SDS cell on the CPU at tiny sizes: its runs through the harness,
untraced and traced; the control and the planted faults come out not
correct; its per-layer readers on readings made by hand; a checkout
whose program lacks ``make_guidance`` stops at once."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from port_bench.harness.context import Readings
from port_bench.harness.loader import Manifest
from port_bench.tests.conftest import ROOT, run_cell

CELL = "sds-1080p"
# the train cell's readers of K2, K3 and the idle share, then the cell's
READERS = ["k2_roofline.gs_step", "k3_roofline.gs_step", "idle.gs_step",
           "encode_ms.sds_step", "prior_ms.sds_step",
           "backward_ms.sds_step", "render_ms.sds_step",
           "k4_roofline.sds_step", "mfu.sds_step"]


@pytest.fixture(scope="module")
def sds_tiny(tmp_path_factory):
    from port_bench.tests.sds_tiny import shrink
    from port_bench.tests.tiny import tiny_bench
    manifest, bench = tiny_bench(str(tmp_path_factory.mktemp("sds")))
    shrink(bench)
    return manifest, bench


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(sds_tiny, trace):
    rc, line, err = run_cell(sds_tiny, CELL, trace)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["check"]) == {"sds_grad_rms", "loss_gap",
                                  "box_grad_gap", "change_gap"}
    if trace:
        # no device events and no device trace on the CPU: the readers
        # find nothing to read and say so
        assert line["metrics"] == {}
        assert "busy_s" in line["device"]
    else:
        assert set(line["metrics"]) == {"gs_step_ms", "setup_s"}


def test_control_fails_the_limits(sds_tiny):
    """The control (the reference's prior in bfloat16) and each planted
    fault, put in the program's place, read over at least one limit;
    the sound program reads under all."""
    import torch
    from port_bench.drivers import sds_step
    from port_bench.harness.context import Run
    m = Manifest(*sds_tiny)
    spec = m.cell(CELL)
    run = Run(torch, torch.device("cpu"), seed=3000000777, seconds=0,
              trace=False, config=m.config(spec), traffic=m.traffic(spec),
              cell=spec, t_start=0.0)
    readings = m.driver(run.traffic).calibrate(run)
    limits = run.traffic["limits"]
    assert set(readings) == {"program", "control", *sds_step.FAULTS}
    for part, gaps in readings.items():
        over = [k for k in limits if gaps[k] > limits[k]]
        assert bool(over) == (part != "program"), (part, gaps)
    assert readings["state_unchanged"]["change_gap"] == 1.0


@pytest.mark.parametrize("fault", ["cond_left_out", "encoder_cut",
                                   "state_unchanged"])
def test_a_broken_timed_path_is_not_correct(sds_tiny, monkeypatch, fault):
    """A run with one planted fault in the program underneath:
    ``correct`` comes out false."""
    import torch
    from multiview_inpaint_tpu_torch.models import sds_trainer
    from multiview_inpaint_tpu_torch.pipelines import sds_train
    from port_bench.drivers.sds_step import faults
    make = sds_train.make_guidance

    def broken(*a):
        guidance = make(*a)
        faults(guidance, fault)
        return guidance

    if fault == "state_unchanged":
        monkeypatch.setattr(sds_trainer, "apply_adam",
                            lambda state, *a, **k: (state, torch.zeros(())))
    else:
        monkeypatch.setattr(sds_train, "make_guidance", broken)
    rc, line, _ = run_cell(sds_tiny, CELL)
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1


def test_manifest_lists_the_cells_metrics():
    m = Manifest(os.path.join(ROOT, "BENCHMARK.json"))
    cell = m.cell(CELL)
    assert cell["chips"] == 1
    assert [x["name"] for x in m.end_to_end(cell)] == ["gs_step_ms",
                                                       "setup_s"]
    assert [x["name"] for x in m.per_layer(cell)] == READERS
    for metric in m.per_layer(cell):
        mod = m.reader(metric)
        assert mod.LAYER == metric["layer"] and mod.MOVES == metric["moves"]


class _Trace:
    def __init__(self, busy_s, k4_s):
        self.busy_s, self.k4_s = busy_s, k4_s

    def durations(self, match):
        if match("flash_fwd_kernel_x"):
            return list(self.k4_s)
        if match("composite_bwd_kernel"):
            return [4e-5]
        return [2e-5] if match("composite_kernel") else []


def _readings(cfg, snapshot=None, trace=None, k4=(), bounds=()):
    r = Readings(cfg, {})
    if snapshot is not None:
        r.captures["telemetry"] = snapshot
    r.captures.update(k4=list(k4), splats=1000, pixels=64 * 48)
    r.memo["splat_bounds"] = list(bounds)
    r.trace, r.traced_units = trace, 8 if trace else 0
    r.units, r.window_s = 10, 2.0
    return r


def _span(count, device_ms):
    return {"count": count, "host_ms": 1.0, "self_host_ms": 1.0,
            "read_ms": 0.0, "device_ms": device_ms}


def test_readers_on_readings_made_by_hand(sds_tiny):
    m = Manifest(*sds_tiny)
    cfg = m.config(m.cell(CELL))
    read = {n: m.reader({"name": n}).read for n in READERS}
    snap = {"spans": {"sds.step": _span(10, 1500.0),
                      "sds.encode": _span(20, 300.0),
                      "sds.prior": _span(10, 600.0),
                      "sds.backward": _span(10, 800.0),
                      "render": _span(10, 170.0)},
            "counters": {}, "units": 10, "dropped": 0}
    r = _readings(cfg, snap, _Trace(1.2, [0.001, 0.002]),
                  k4=[(2, 2, 64, 16, 4), (2, 4, 16, 16, 4)],
                  bounds=[(1e-5, 2e-5, 3e-5)])
    assert read["encode_ms.sds_step"](r) == 30.0
    assert read["prior_ms.sds_step"](r) == 60.0
    assert read["backward_ms.sds_step"](r) == 80.0
    assert read["render_ms.sds_step"](r) == 17.0
    # idle: 1 - (1.2 s / 8 steps) / (2.0 s / 10 steps)
    assert read["idle.gs_step"](r) == pytest.approx(25.0)
    # K2's and K3's bounds over their first launches' times
    assert read["k2_roofline.gs_step"](r) == pytest.approx(100.0)
    assert read["k3_roofline.gs_step"](r) == pytest.approx(75.0)
    from port_bench.counts.attention import k4_bound_s
    assert read["k4_roofline.sds_step"](r) == pytest.approx(
        100.0 * (k4_bound_s(2, 2, 64, 16, 4) + k4_bound_s(2, 4, 16, 16, 4))
        / 0.003)
    from port_bench.counts.peaks import BF16_FLOP_PER_S
    from port_bench.counts.sds_flops import sds_flops
    from port_bench.counts.splat_step import step_bound_s
    flops = sds_flops(cfg)
    assert flops["step"] == (flops["prior"] + 2 * flops["encode"]
                             + flops["encode_backward"]) > 0
    least = (flops["step"] / BF16_FLOP_PER_S
             + step_bound_s(1000, 64 * 48, 1e-5, 2e-5, 3e-5))
    assert read["mfu.sds_step"](r) == pytest.approx(100.0 * least / 0.2)
    # a program without the spans, a run without device events, a K4
    # count that does not match: nothing to read, no error
    bare = _readings(cfg)
    assert all(read[n](bare) is None for n in READERS)
    snap["spans"]["sds.prior"]["device_ms"] = None
    assert read["prior_ms.sds_step"](r) is None
    r.trace.k4_s = [0.001]
    assert read["k4_roofline.sds_step"](r) is None


def test_a_checkout_without_make_guidance_stops_at_once(sds_tiny, tmp_path,
                                                        monkeypatch):
    """The parent of this cell has no ``sds_train.make_guidance``: the run
    raises before any set-up."""
    from multiview_inpaint_tpu_torch.pipelines import sds_train
    monkeypatch.delattr(sds_train, "make_guidance")
    with pytest.raises(ImportError):
        run_cell(sds_tiny, CELL)
    with open(sds_tiny[0]) as f:
        data = json.load(f)
    data["workloads"] = [w for w in data["workloads"] if w["name"] != CELL]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(data))
    bench = tmp_path / "port_bench"
    shutil.copytree(sds_tiny[1], bench)
    with pytest.raises(KeyError, match="no workload"):
        run_cell((str(path), str(bench)), CELL)
