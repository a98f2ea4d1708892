"""Least time of the rasterizer's kernels on one frame's inputs.

The walk (``walk_counts``) counts, on the frame's own pair lists, the
pair-pixels the composite's forward walk visits (the pixel's T_in is
still >= 1e-4 in the chunk), keeps (they pass the gate) and where they
contribute (T_out >= 1e-4), by the reference's recomputation of each
chunk. Each is charged its least operations: (FP32 ops, special-function
ops) per pair-pixel
- walked: the gate (2 subs, 9 ops of the quadratic form, the opacity
  product, the clamp and 2 compares) and the exp of the power: (15, 1);
- kept: log1p(-alpha) as 4 ops, the add, product and compare of the stop
  test, and the exp of the in-chunk prefix: (7, 1);
- contributing: K2 adds the exp of T_in, its sub and product, the weight
  and the 4 accumulators: (8, 1); K3 adds the exp of T_in and the
  reciprocal of its division, ~40 ops of A, the w.A prefix, dL/dalpha,
  the ten row terms and the 10 adds over the tile's pixels: (50, 2).
A kernel's bound is the longer of that time and its bytes' time:
K1 writes 8 bytes a pair and reads 20 a pair-emitting splat; K2 reads 64
bytes a pair and 16 a tile and writes 8 float rows a pixel; K3 reads and
writes 64 bytes a pair, reads 16 a tile and 2 x 8 float rows a pixel.
"""

from __future__ import annotations

import torch

from port_bench.reference.gs import composite as c

from .peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S, SFU_OP_PER_S

WALK_OPS, KEEP_OPS = (15, 1), (7, 1)
K2_CONTRIB_OPS, K3_CONTRIB_OPS = (8, 1), (50, 2)


@torch.no_grad()
def walk_counts(attrs, seg_start, counts, tiles_x, tiles_y, th, tw) -> list:
    dev = attrs.device
    coords = c.tile_pixel_coords(tiles_x, tiles_y, tw, th, dev)
    t_carry = torch.ones((tiles_x * tiles_y, th * tw), device=dev)
    lane = torch.arange(c.CHUNK, device=dev)
    zero = torch.zeros((), device=dev)
    n = torch.zeros(3, dtype=torch.int64, device=dev)
    for c0, tl in c._chunks(counts, th * tw, c.CHUNK):
        s = c._chunk(attrs, seg_start, counts, coords, t_carry, tl, c0,
                     lane, zero)
        walked = s.ok[:, None, :] & (s.t_in >= c.T_STOP)
        kept = walked & s.keep
        n += torch.stack([walked.sum(), kept.sum(),
                          (kept & s.contrib).sum()])
        t_carry[tl] = t_carry[tl] * torch.exp(torch.sum(
            torch.where(s.contrib, s.logs, zero), dim=-1))
    return n.tolist()


def _ops_s(walk, contrib_ops) -> float:
    flop = sfu = 0
    for n, (f, u) in zip(walk, (WALK_OPS, KEEP_OPS, contrib_ops)):
        flop += n * f
        sfu += n * u
    return max(flop / FP32_FLOP_PER_S, sfu / SFU_OP_PER_S)


def k1_bound_s(total_pairs: int, n_active: int) -> float:
    return (total_pairs * 8 + n_active * 20) / HBM_BYTES_PER_S


def k2_bound_s(walk, n_pairs, n_tiles, pix) -> float:
    t_bytes = (n_pairs * 64 + n_tiles * 16 + n_tiles * 8 * pix * 4) \
        / HBM_BYTES_PER_S
    return max(t_bytes, _ops_s(walk, K2_CONTRIB_OPS))


def k3_bound_s(walk, n_pairs, n_tiles, pix) -> float:
    t_bytes = (n_pairs * 64 * 2 + n_tiles * 16 + n_tiles * pix * 2 * 32) \
        / HBM_BYTES_PER_S
    return max(t_bytes, _ops_s(walk, K3_CONTRIB_OPS))


def captured_bounds(r) -> list:
    """[(k1_s, k2_s, k3_s)] of each frame whose pair lists a traced run
    kept (``r.captures["k2"]``, with its K1 totals in ``r.captures["k1"]``
    in the same order), computed once per run."""
    if "splat_bounds" not in r.memo:
        out = []
        for (attrs, seg_start, counts, size), (total, active) in zip(
                r.captures.get("k2", []), r.captures.get("k1", [])):
            tiles_x, tiles_y, th, tw = size
            walk = walk_counts(attrs, seg_start, counts, *size)
            n_tiles, pix = tiles_x * tiles_y, th * tw
            n_pairs = attrs.shape[0]
            out.append((k1_bound_s(total, active),
                        k2_bound_s(walk, n_pairs, n_tiles, pix),
                        k3_bound_s(walk, n_pairs, n_tiles, pix)))
        r.memo["splat_bounds"] = out
    return r.memo["splat_bounds"]


def roofline(r, kernel: str, which: int):
    """100 x the captured frames' least time of one kernel (``which``: 1
    K2, 2 K3) over the device time of its first launches in the trace."""
    bounds = captured_bounds(r)
    if r.trace is None or not bounds:
        return None
    times = r.trace.durations(lambda n: kernel in n)[:len(bounds)]
    if len(times) < len(bounds) or not sum(times):
        return None
    return 100.0 * sum(b[which] for b in bounds) / sum(times)
