"""The counting functions against hand counts."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.counts import attention, composite, peaks, splat_step
from port_bench.harness.trace import TraceSummary
from port_bench.harness.context import Readings
from port_bench.reference.gs import composite as ref_composite
from port_bench.reference.svd.attention import attention as plain_attention


@pytest.mark.parametrize("b,h,t,d", [(1, 1, 2, 3), (28, 5, 3072, 64),
                                     (14, 10, 768, 64)])
def test_flash_attention_counts(b, h, t, d):
    assert attention.k4_flop(b, h, t, d) == 2 * 2 * b * h * t * t * d
    k4 = attention.k4_bound_s(b, h, t, d)
    assert k4 == max(4 * b * h * t * t * d / peaks.BF16_FLOP_PER_S,
                     b * h * t * t / peaks.SFU_OP_PER_S,
                     4 * b * t * h * d * 2 / peaks.HBM_BYTES_PER_S)


def test_flop_counter_counts_attention_and_layers_by_hand():
    b, t, heads, d = 2, 24, 3, 8
    q = torch.randn(b, t, heads * d)
    with FlopCounterMode(display=False) as fc:
        plain_attention(q, q, q, heads)
    assert fc.get_total_flops() == 2 * (2 * b * heads * t * t * d)
    lin = torch.nn.Linear(16, 32)
    conv = torch.nn.Conv2d(4, 8, 3, padding=1)
    with FlopCounterMode(display=False) as fc:
        lin(torch.randn(5, 16))
        conv(torch.randn(1, 4, 6, 7))
    assert fc.get_total_flops() == 2 * 5 * 16 * 32 + 2 * 8 * 6 * 7 * 4 * 9


def test_clip_flops_of_a_tiny_model():
    from port_bench.counts.svd_flops import clip_flops
    from port_bench.tests.tiny import TINY_SVD, _merge
    from port_bench.harness.loader import load_json
    from port_bench.tests.conftest import ROOT
    cfg = _merge(load_json(f"{ROOT}/port_bench/configs/svd-xt-ctrlnet.json"),
                 TINY_SVD)
    f = clip_flops(cfg, 3)
    assert f["clip"] == f["cond"] + 3 * f["evaluation"] + f["decode"]
    assert min(f.values()) > 0


def test_splat_step_bytes_by_hand():
    n, pixels = 2_000_000, 1920 * 1080
    assert math.isclose(splat_step.step_bound_s(n, pixels, 0, 0, 0),
                        (n * 59 * 4 * 8 + pixels * 3 * 4 * 2) / 3.35e12)
    assert math.isclose(splat_step.frame_bound_s(n, pixels, 1e-3, 2e-3),
                        (n * 59 * 4 + pixels * 16) / 3.35e12 + 3e-3)
    assert composite.k1_bound_s(100, 10) == (800 + 200) / 3.35e12


def _brute_walk(attrs, coords):
    """Per pixel, splat by splat in depth order (one chunk): walked,
    kept, contributing."""
    walked = kept = contrib = 0
    for px, py in coords.tolist():
        t = 1.0
        for a in attrs.tolist():
            if t < ref_composite.T_STOP:
                break
            walked += 1
            dx, dy = px - a[0], py - a[1]
            power = -0.5 * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy
            alpha = min(ref_composite.ALPHA_MAX, a[5] * math.exp(power))
            if alpha >= a[10] and power <= 0:
                kept += 1
                if t * (1 - alpha) >= ref_composite.T_STOP:
                    contrib += 1
                    t *= 1 - alpha
                else:
                    break
    return [walked, kept, contrib]


def test_walk_counts_by_brute_force():
    g = torch.Generator().manual_seed(0)
    n = 40
    attrs = torch.zeros(n, 16)
    attrs[:, :2] = torch.rand(n, 2, generator=g) * 16
    attrs[:, 2] = attrs[:, 4] = 0.05 + 0.2 * torch.rand(n, generator=g)
    attrs[:, 5] = 0.3 + 0.69 * torch.rand(n, generator=g)
    attrs[:, 10] = ref_composite.alpha_gate(attrs[:, 5])
    seg, counts = torch.tensor([0]), torch.tensor([n])
    coords = ref_composite.tile_pixel_coords(1, 1, 16, 16)[0]
    assert composite.walk_counts(attrs, seg, counts, 1, 1, 16, 16) == \
        _brute_walk(attrs, coords)


def test_roofline_readers_from_a_trace():
    """k1_roofline over two frames: bound over measured device time; no
    trace, no number."""
    from port_bench.harness.loader import load_module
    from port_bench.tests.conftest import ROOT
    reader = load_module(f"{ROOT}/port_bench/metrics/k1_roofline.frame.py",
                         "k1r")
    r = Readings({}, {})
    assert reader.read(r) is None
    r.captures["k1"] = [(1000, 50), (3000, 70)]
    r.trace = TraceSummary([(0, 2000, "expand_keys_kernel(long long)"),
                            (5000, 9000, "expand_keys_kernel(long long)"),
                            (2000, 3000, "other")], [], 1e-5)
    want = (composite.k1_bound_s(1000, 50) + composite.k1_bound_s(3000, 70)) \
        / 6e-6
    assert math.isclose(reader.read(r), 100 * want)
    assert math.isclose(r.trace.busy_s, 7e-6)


@pytest.mark.parametrize("name", ["idle.clip", "idle.gs_step", "idle.frame"])
def test_idle_readers_divide_traced_busy_by_the_untraced_unit(name):
    """Device-busy seconds per traced unit over the window's mean unit
    time, whatever the traced stretch's own host time; no trace, no
    number."""
    from port_bench.harness.loader import load_module
    from port_bench.tests.conftest import ROOT
    reader = load_module(f"{ROOT}/port_bench/metrics/{name}.py",
                         name.replace(".", "_"))
    r = Readings({}, {})
    assert reader.read(r) is None
    r.units, r.window_s, r.traced_units = 10, 1.0, 2
    # two traced units, 0.15 s busy in all, over a stretch the profiler
    # stretched to 0.5 s
    r.trace = TraceSummary([(0, 100_000_000, "k"),
                            (300_000_000, 350_000_000, "k")], [], 0.5)
    assert math.isclose(reader.read(r), 100 * (1 - 0.075 / 0.1))
