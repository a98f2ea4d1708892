"""The composite's work items, on the CPU: the item numbering that the
CUDA backward (K3) takes its blocks from, the per-item state that the
forward (K2) records, and the plain K3 started from that state.

A tile's segment is cut into items of ``ITEM_PAIRS`` pairs; K2 can record
the carried T and the accumulators at each item's start, and K3 starts
every item from them. The plain versions do the same, so these tests hold
what the kernels are held against on the card.
"""

import numpy as np
import pytest
import torch

from multiview_inpaint_tpu_torch.ops.rasterizer import composite as c
from multiview_inpaint_tpu_torch.ops.rasterizer.composite_cuda import (
    composite, pack_attrs)

M = c.ITEM_PAIRS
TILE = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's many small ops on one intra-op thread: on PyTorch's
    default threads they thrash when several test workers share the
    cores (this file took 20-50x longer in the 6-worker Tier-1 run than
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_item_constants_match_the_kernels():
    src = (c.__file__.rsplit("/ops/", 1)[0]
           + "/csrc/composite_common.cuh")
    text = open(src).read()
    assert f"constexpr int kItemChunks = {c.ITEM_CHUNKS};" in text
    assert f"constexpr int kChunk = {c.CHUNK};" in text
    assert M == c.ITEM_CHUNKS * c.CHUNK


def test_k3_early_gate_reject_is_below_every_packed_gate():
    """K3 drops a splat whose power is below kPowerGated before its gate
    test; no splat there may pass the gate that pack_attrs packs (row 10,
    ``alpha_gate``): opacity * exp(kPowerGated) stays under the gate with
    room for expf's and the products' rounding, at every opacity."""
    src = (c.__file__.rsplit("/ops/", 1)[0]
           + "/csrc/composite_common.cuh")
    line = next(ln for ln in open(src)
                if ln.startswith("constexpr float kPowerGated"))
    power = float(line.split("=")[1].strip().rstrip(";").rstrip("f"))
    op = torch.cat([torch.logspace(-6, 0, 4001, dtype=torch.float32),
                    torch.tensor([c.ALPHA_MIN / c.GATE_E, 1.0])])
    gate = c.alpha_gate(op)
    assert torch.equal(pack_attrs(torch.zeros((op.numel(), 2)),
                                  torch.zeros((op.numel(), 3)), op,
                                  torch.zeros((op.numel(), 3)),
                                  torch.zeros(op.numel()))[:, 10], gate)
    reach = op.double() * float(np.exp(np.float32(power)))
    assert bool((reach * 1.05 < gate.double()).all())


SEGMENTS = [0, 1, 127, 128, 129, M - 1, M, M + 1, 2 * M, 3 * M + 5, 0,
            5 * M - 1]


@pytest.mark.parametrize("counts", [
    SEGMENTS, [0, 0, 0], [M] * 7, [1] * 9, [3 * M + 1], [M - 1, M + 1]])
def test_items_cover_every_chunk_of_every_tile_once(counts):
    """Each block number b < max_items finds its tile by a search of the
    inclusive ends (as the kernel's binary search does): the items of a
    tile are its chunks [e * ITEM_CHUNKS, (e + 1) * ITEM_CHUNKS), every
    chunk of every tile lies in exactly one item, and the blocks past the
    last item find none."""
    counts = torch.tensor(counts, dtype=torch.int64)
    ends = c.item_ends(counts)
    n_items = c.max_items(counts.numel(), int(counts.sum()))
    assert int(ends[-1]) <= n_items
    seen = {}
    for b in range(n_items):
        tile = int(torch.searchsorted(ends, b, right=True))
        if tile == counts.numel():
            assert b >= int(ends[-1])
            continue
        n_tile = -(-int(counts[tile]) // M)
        e = b - (int(ends[tile]) - n_tile)
        assert 0 <= e < n_tile
        n_chunks = -(-int(counts[tile]) // c.CHUNK)
        for k in range(e * c.ITEM_CHUNKS,
                       min((e + 1) * c.ITEM_CHUNKS, n_chunks)):
            assert (tile, k) not in seen
            seen[(tile, k)] = b
        # The plain versions' numbering of the item's first chunk.
        got = c._item_of(ends, counts, torch.tensor([tile]), e * M)
        assert int(got) == b
    want = {(t, k) for t, n in enumerate(counts.tolist())
            for k in range(-(-n // c.CHUNK))}
    assert set(seen) == want


def _deep_frame(counts, seed):
    """Packed attrs of faint splats over a row of 16x16 tiles, each tile's
    segment ``counts[t]`` splats long: a deep tile's pixels still see
    through its first two items and stop inside the later chunks."""
    rng = np.random.default_rng(seed)
    tile_of = np.repeat(np.arange(len(counts)), counts)
    n = tile_of.size
    means = np.stack([tile_of * TILE + rng.uniform(-4, TILE + 4, n),
                      rng.uniform(-4, TILE + 4, n)], -1)
    sx, sy = rng.uniform(2, 8, n), rng.uniform(2, 8, n)
    rho = rng.uniform(-0.5, 0.5, n)
    det = (1 - rho ** 2) * sx ** 2 * sy ** 2
    conic = np.stack([sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det],
                     -1)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    attrs = pack_attrs(f(means), f(conic), f(rng.uniform(0.005, 0.03, n)),
                       f(rng.uniform(0, 1, (n, 3))), f(rng.uniform(1, 5, n)))
    counts = torch.tensor(counts, dtype=torch.int64)
    seg_start = torch.cumsum(counts, 0) - counts
    return attrs.contiguous(), seg_start, counts


DEEP = [3 * M + 200, 0, M, M + 1, 129]


def _stops_per_chunk(attrs, seg_start, counts):
    """Pixels of each tile that stop (a kept splat with T_out < 1e-4)
    inside each chunk of the plain walk: [tiles, chunks]."""
    n_t = counts.numel()
    coords = c.tile_pixel_coords(n_t, 1, TILE, TILE)
    t_carry = torch.ones((n_t, TILE * TILE))
    lane = torch.arange(c.CHUNK)
    zero = torch.zeros(())
    out = torch.zeros((n_t, -(-int(counts.max()) // c.CHUNK)),
                      dtype=torch.int64)
    for c0, tl in c._chunks(counts, TILE * TILE, c.CHUNK):
        s = c._chunk(attrs, seg_start, counts, coords, t_carry, tl, c0,
                     lane, zero)
        out[tl, c0 // c.CHUNK] = (s.keep & ~s.contrib).any(-1).sum(-1)
        t_carry[tl] = t_carry[tl] * torch.exp(torch.sum(
            torch.where(s.contrib, s.logs, zero), dim=-1))
    return out


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_deep_frame_stops_inside_several_chunks(seed):
    """The deep tile's pixels stop inside several chunks of two or more
    items, and are far from stopped where its second item starts."""
    attrs, seg_start, counts = _deep_frame(DEEP, seed)
    stops = _stops_per_chunk(attrs, seg_start, counts)[0]
    chunks = torch.nonzero(stops).flatten()
    assert chunks.numel() >= 4
    assert len(set((chunks // c.ITEM_CHUNKS).tolist())) >= 2
    _, state = c.composite_segments(attrs, seg_start, counts, len(DEEP), 1,
                                    TILE, TILE, with_state=True)
    assert float(state[1, 0].min()) > 100 * c.T_STOP


def test_plain_k2_state_leaves_the_tiles_unchanged():
    attrs, seg_start, counts = _deep_frame(DEEP, 1)
    args = (attrs, seg_start, counts, len(DEEP), 1, TILE, TILE)
    tiles8, state = c.composite_segments(*args, with_state=True)
    assert torch.equal(tiles8, c.composite_segments(*args))
    assert state.shape == (c.max_items(len(DEEP), attrs.shape[0]),
                           c.STATE_ROWS, TILE * TILE)


def test_plain_k2_state_is_its_own_sequential_carry():
    """The state at the start of item e of a tile is, bit for bit, the
    carry T and the accumulators of the same walk cut off at e * M
    pairs; the first item of every tile starts at T = 1 and zero
    accumulators."""
    attrs, seg_start, counts = _deep_frame(DEEP, 2)
    args = (len(DEEP), 1, TILE, TILE)
    _, state = c.composite_segments(attrs, seg_start, counts, *args,
                                    with_state=True)
    ends = c.item_ends(counts)
    first = ends - (counts + M - 1) // M
    busy = counts > 0
    assert torch.equal(state[first[busy], 0],
                       torch.ones((int(busy.sum()), TILE * TILE)))
    assert not state[first[busy], 1:].any()
    checked = 0
    for e in range(1, -(-int(counts.max()) // M)):
        cut = torch.clamp(counts, max=e * M)
        raw = c.composite_segments(attrs, seg_start, cut, *args)
        for t in torch.nonzero(counts > e * M).flatten().tolist():
            st = state[int(first[t]) + e]
            assert torch.equal(st[0], raw[t, 4])
            assert torch.equal(st[1:], raw[t, 0:4])
            checked += 1
    assert checked >= 3


def _bar_share(got, want):
    bar = 2e-6 + 1e-4 * want.abs().amax(dim=0)
    return float(((got - want).abs() > bar).any(dim=1).float().mean())


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_k3_from_the_item_state_matches_the_sequential_walk(seed):
    """On a deep tile whose pixels stop inside several chunks, the plain
    K3 started from the per-item state agrees with the plain K3 that
    walks every tile from its start, at the gradient bar 2e-6 + 1e-4
    max|row| on every pair (the gate and stop decisions are the same; only
    the prefix of w.A is summed in another order), and rows 10-15 stay
    0."""
    attrs, seg_start, counts = _deep_frame(DEEP, seed)
    args = (len(DEEP), 1, TILE, TILE)
    tiles8, state = c.composite_segments(attrs, seg_start, counts, *args,
                                         with_state=True)
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=tiles8.shape).astype(np.float32))
    g[:, 5:] = 0
    want = c.composite_segments_bwd(attrs, seg_start, counts, tiles8, g,
                                    *args)
    got = c.composite_segments_bwd(attrs, seg_start, counts, tiles8, g,
                                   *args, state)
    assert float(want[:, :10].abs().max()) > 0
    assert _bar_share(got[:, :10], want[:, :10]) == 0.0
    assert not got[:, 10:].any()
    # The items past the first of each tile do start from the state: a
    # wrong state moves them.
    bad = state.clone()
    ends = c.item_ends(counts)
    bad[int(ends[0]) - 3] = state[int(ends[0]) - 2]
    off = c.composite_segments_bwd(attrs, seg_start, counts, tiles8, g,
                                   *args, bad)
    assert _bar_share(off[:, :10], want[:, :10]) > 0


def test_cpu_autograd_records_the_state_only_for_a_backward(monkeypatch):
    """``composite`` on CPU tensors: the forward asks the plain K2 for the
    state only when attrs needs a gradient, and the backward hands it to
    the plain K3."""
    attrs, seg_start, counts = _deep_frame([M + 3, 40], 5)
    calls = []
    real_fwd, real_bwd = c.composite_segments, c.composite_segments_bwd
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite_cuda

    def fwd(*a, **kw):
        calls.append(("fwd", kw.get("with_state", False)))
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls.append(("bwd", a[-1] is not None))
        return real_bwd(*a, **kw)

    monkeypatch.setattr(composite_cuda, "composite_segments", fwd)
    monkeypatch.setattr(composite_cuda, "composite_segments_bwd", bwd)
    composite(attrs, seg_start, counts, 2, 1, TILE, TILE)
    leaf = attrs.clone().requires_grad_(True)
    out = composite(leaf, seg_start, counts, 2, 1, TILE, TILE)
    out[:, :5].sum().backward()
    assert calls == [("fwd", False), ("fwd", True), ("bwd", True)]
    assert torch.isfinite(leaf.grad).all() and leaf.grad[:, :10].any()
