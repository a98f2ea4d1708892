#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Drives ``multiview_inpaint_tpu_torch`` only (never JAX, never the JAX
package), phase by phase, one line each; any failure raises and exits
non-zero:

1. the card (``nvidia-smi`` name and power limit), torch, TF32 settings
   (both TF32 switches are set off, so the plain versions run in fp32;
   phase 7 puts them back to PyTorch's defaults for its own checks);
2. build the CUDA kernels from ``multiview_inpaint_tpu_torch/csrc``;
3. K1 (pair keys) against its plain version, bit for bit, on the 1080p
   bench frames of the 100k bench ball and the 2M-gaussian scene;
4. K2 (composite) against its plain version on the same frames: max
   errors, pixels beyond rgb 3e-5 / depth 3e-4 (at most 0.01%), every
   pixel within the stop-flip bound;
5. K3 (composite backward) against its plain version on the same frames
   under a seeded cotangent (``check_k3``): max error per row, pairs
   beyond 2e-6 + 1e-4 max|row| (at most 0.01%), the same for the
   per-gaussian gradients after the gather's backward, every pair and
   gaussian within the flip allowance, rows 10-15 exactly 0, bit-equal
   on a second run;
6. the port's whole render path on CUDA against its CPU path on a small
   scene, 16x16 and 8x16 tiles: images (rgb 3e-5, depth 3e-4) and the
   gradients of a loss on them, means2d_offset's included (through K3 on
   CUDA, at 2e-6 + 1e-4 max|g|);
7. SSIM on CUDA with the TF32 switches at PyTorch's defaults: self-SSIM
   of a 512x384 image is 1, a smooth near-identical pair is <= 1, CUDA
   matches the CPU within 1e-6 (value) and at the gradient bar (its
   gradient);
8. one CUDA ``train_step`` against the CPU ``train_step`` on the
   300-splat 96x64 scene of phase 6: loss within 1e-5 relative, every
   field's gradient (from the Adam moments), mu, nu and the densification
   statistics at 2e-6 + 1e-4 max|g|;
9. main path 1: the ``render`` CLI on a 1920x1080 COLMAP scene (the
   bench camera and three yaw offsets) holding a 2M-gaussian PLY, with
   the kernel launch counters zeroed before and read after; then, for
   that scene and the 100k bench ball, the median ms/frame over those
   views (CUDA events, after one warm-up view) and a per-stage split of
   the bench view;
10. main path 2 on an 8-view 960x540 orbit scene rendered from the
    2M-gaussian scene, from 200,000 of its points: first one
    ``train_step`` of that scene, whose K3 call (the real L1+SSIM
    cotangent) is held against the plain K3 as in phase 5 and sets the
    densification threshold (a quantile of that step's screen-space
    gradient norms); then the ``train_gs`` CLI for 60 iterations in a
    buffer a little larger than the init, counters zeroed before and read
    after: loss falls, densify ran twice and wrote rows, the capacity
    grew, PLY and npz written, no non-finite gradient, K3 launched once
    per step;
11. the train step at full width: the 2M-gaussian bench ball in a
    2,097,152-row buffer at 512x384, median ms/step over 10 steps after
    2 warm-up steps (CUDA events), the split of the real step into render
    forward, loss, backward (loss/assembly, K3, the gather's backward, the
    projection's backward) and Adam (``StepProbe``), and its K3 call held
    against the plain K3 as in phase 5;
12. the ``kernels`` JSON line (K1 and K2 at main path 1's big2m frame, K3
    at main path 2's first step); the last line is the ``ok`` JSON
    object.

Build outputs and the scenes go under ``build/`` in the checkout.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
BALL_N, BIG_N = 100_000, 2_000_000
YAWS = (0.0, -0.06, 0.06, 0.12)   # the bench view and three yaw offsets

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM rate and
# FP32 rate outside the tensor cores; the special-function rate is the
# same clock's 16 MUFU ops per SM per cycle (132 SMs x 16 x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_OP_PER_S = 132 * 16 * 1.98e9
# The least operations of the composite kernels, as (FP32 ops,
# special-function ops) per pair-pixel by what the forward walk does
# there; ``walk_counts`` counts those pair-pixels on the run's inputs.
# - walked (the pixel has not stopped earlier in the chunk): the gate,
#   i.e. 2 subs, 9 ops of the quadratic form, the opacity product, the
#   clamp and 2 compares, and the exp of the power;
# - kept (passes the gate): log1p(-alpha), counted as 4 FP32 ops (fewer
#   than its polynomial), the add, product and compare of the stop test,
#   and the exp of the in-chunk prefix;
# - contributing (kept, T_out >= 1e-4): K2 adds the exp of T_in, its sub
#   and product, the weight and the 4 accumulators; K3 adds the exp of
#   T_in and the reciprocal of its division, ~40 ops of A, the w.A
#   prefix, dL/dalpha and the ten row terms, and 10 adds that sum the
#   rows over the tile's pixels.
WALK_OPS, KEEP_OPS = (15, 1), (7, 1)
K2_CONTRIB_OPS, K3_CONTRIB_OPS = (8, 1), (50, 2)
RGB_TOL, DEPTH_TOL, BAD_FRACTION = 3e-5, 3e-4, 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-6, 1e-4   # gradient bar: atol + rtol * max|g|
TILE = 16
# Main path 2 (the train CLI) and the full-width train step.
TRAIN_W, TRAIN_H, TRAIN_VIEWS, TRAIN_POINTS = 960, 540, 8, 200_000
TRAIN_ITERS = 60
# Main path 2 densifies the rows whose mean screen-space gradient norm
# reaches this quantile of the first step's norms, in a buffer this many
# rows larger than the init: the first densification fills the spare rows
# and grows the buffer.
DENSIFY_QUANTILE, TRAIN_SPARE_ROWS = 0.8, 1024
STEP_N, STEP_CAPACITY, STEP_W, STEP_H = 2_000_000, 2_097_152, 512, 384


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(torch, fn, iters):
    """Mean device ms per call over ``iters`` back-to-back calls, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def grad_bar(want, dim=None):
    """The gradient bar 2e-6 + 1e-4 max|want| (per column with dim=0)."""
    m = want.abs().amax() if dim is None else want.abs().amax(dim=dim)
    return GRAD_ATOL + GRAD_RTOL * m


def walk_counts(torch, attrs, seg_start, counts, size):
    """(walked, kept, contributing) pair-pixels of the composite's forward
    walk on these inputs, from the plain version's own recomputation of
    each chunk (``composite._chunk``): a pixel walks a splat while its
    T_in >= 1e-4 in the chunk, keeps it when it passes the gate, and it
    contributes when kept with T_out >= 1e-4."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite as c
    tiles_x, tiles_y, th, tw = size
    dev = attrs.device
    coords = c.tile_pixel_coords(tiles_x, tiles_y, tw, th, dev)
    t_carry = torch.ones((tiles_x * tiles_y, th * tw), device=dev)
    lane = torch.arange(c.CHUNK, device=dev)
    zero = torch.zeros((), device=dev)
    n = torch.zeros(3, dtype=torch.int64, device=dev)
    with torch.no_grad():
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


def bound(t_bytes, walk, contrib_ops):
    """``bound_ms`` and ``bound_by`` of a composite kernel: the larger of
    its bytes' time ``t_bytes`` (s) and the time of its least operations
    on the ``walk_counts`` pair-pixels ``walk``."""
    flop = sfu = 0
    for n, (f, u) in zip(walk, (WALK_OPS, KEEP_OPS, contrib_ops)):
        flop += n * f
        sfu += n * u
    t_ops = max(flop / FP32_FLOP_PER_S, sfu / SFU_OP_PER_S)
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def walk_shares(walk, pair_pixels):
    return [round(n / max(pair_pixels, 1), 4) for n in walk]


def phase_card(torch):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} | tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32} (set off for the plain "
          f"versions)", flush=True)
    return card


def phase_build():
    from multiview_inpaint_tpu_torch.ops.rasterizer import _kernels
    t0 = time.perf_counter()
    lib_path = _kernels.build()
    _kernels.library()
    print(f"[2 build] {os.path.relpath(lib_path, REPO)} from "
          f"{', '.join(_kernels.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_kernels(torch, card, name, params):
    """Phases 3-5 on one 1080p bench frame; returns the K1 and K2 records
    of the kernels line (launches filled in later)."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        RenderCamera, api, binning, composite, composite_cuda, pair_expand)
    from multiview_inpaint_tpu_torch.utils import synthetic

    cam = RenderCamera.from_camera(synthetic.bench_camera(), DEVICE)
    tiles_x, tiles_y = -(-cam.width // TILE), -(-cam.height // TILE)
    n_tiles, pix = tiles_x * tiles_y, TILE * TILE
    size = (tiles_x, tiles_y, TILE, TILE, cam.width, cam.height)
    with torch.no_grad():
        proj = api.project(params, cam, 0)
    r = binning.compact_rects(proj.means2d, proj.radius, proj.depth,
                              tiles_x, tiles_y, TILE, TILE, proj.extent)
    k1_args = (r.starts, r.x0, r.y0, r.w, r.count, r.n_active, r.total,
               tiles_x)
    keys = pair_expand.expand_keys(*k1_args)
    keys_ref = pair_expand.expand_keys_ref(*k1_args)
    sorted_k = torch.sort(keys).values
    sorted_p = torch.sort(keys_ref).values
    seg_k = binning.segments_from_keys(sorted_k, n_tiles)
    seg_p = binning.segments_from_keys(sorted_p, n_tiles)
    if not (torch.equal(keys, keys_ref) and torch.equal(sorted_k, sorted_p)
            and all(torch.equal(a, b) for a, b in zip(seg_k, seg_p))):
        fail(f"K1 keys/segments differ from the plain version on {name}")
    k1_ms = cuda_ms(torch, lambda: pair_expand.expand_keys(*k1_args), 50)
    k1_plain_ms = cuda_ms(torch,
                          lambda: pair_expand.expand_keys_ref(*k1_args), 5)
    k1_bytes = r.total * 8 + r.n_active * (8 + 4 + 4 + 4 + 8)
    k1 = dict(max_abs_err=0.0, ms=k1_ms, plain_ms=k1_plain_ms,
              bound_ms=k1_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
              library_ms=None)
    print(f"[3 K1 {name}] n={params.capacity} actives={r.n_active} "
          f"pairs={r.total}: keys, sorted keys, seg_start, counts equal | "
          f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, bound "
          f"{k1['bound_ms']:.4f} ms (bytes) | {card}", flush=True)

    counts, seg_start = seg_k
    gid = r.order[sorted_k & 0xFFFFFFFF]          # gaussian of each pair
    attrs = composite_cuda.pack_attrs(
        proj.means2d, proj.conic, proj.opacity, proj.color,
        proj.depth)[gid].contiguous()
    k2_args = (attrs, seg_start, counts, tiles_x, tiles_y, TILE, TILE)
    with torch.no_grad():
        out_k = composite_cuda.composite_fwd(*k2_args)
        out_p = composite.composite_segments(*k2_args)
    if not (torch.isfinite(out_k).all() and torch.isfinite(out_p).all()):
        fail(f"K2 output not finite on {name}")

    def image(t8):
        tiles = t8.transpose(1, 2)                       # [T, PIX, 8]
        return (api.assemble(tiles[..., 0:3], *size),
                api.assemble(tiles[..., 3] + tiles[..., 4]
                             * composite.DEPTH_EMPTY, *size),
                api.assemble(tiles[..., 4], *size))

    (rgb_k, d_k, t_k), (rgb_p, d_p, t_p) = image(out_k), image(out_p)
    e_rgb = (rgb_k - rgb_p).abs().amax(-1)
    e_d = (d_k - d_p).abs()
    e_t = (t_k - t_p).abs()
    n_pix = e_d.numel()
    bad = int(((e_rgb > RGB_TOL) | (e_d > DEPTH_TOL)).sum())
    # A flipped stop decision moves a pixel by at most T_in <=
    # T_STOP / (1 - 0.99) = 1e-2 times that splat's colour or depth (and
    # the depth sentinel through the final T).
    flip_t = composite.T_STOP / (1.0 - composite.ALPHA_MAX)
    c_max = float(attrs[:, 6:9].abs().max()) if r.total else 0.0
    d_max = float(attrs[:, 9].abs().max()) if r.total else 0.0
    within = bool((e_rgb <= flip_t * c_max + RGB_TOL).all()
                  and (e_d <= flip_t * (d_max + composite.DEPTH_EMPTY)
                       + DEPTH_TOL).all()
                  and (e_t <= flip_t + RGB_TOL).all())
    k2_ms = cuda_ms(torch, lambda: composite_cuda.composite_fwd(*k2_args),
                    10)
    with torch.no_grad():
        k2_plain_ms = cuda_ms(
            torch, lambda: composite.composite_segments(*k2_args), 1)
    walk = walk_counts(torch, attrs, seg_start, counts,
                       (tiles_x, tiles_y, TILE, TILE))
    t_bytes = (r.total * 64 + n_tiles * 16
               + n_tiles * 8 * pix * 4) / HBM_BYTES_PER_S
    k2 = dict(max_abs_err=float(max(e_rgb.max(), e_d.max(), e_t.max())),
              ms=k2_ms, plain_ms=k2_plain_ms,
              **bound(t_bytes, walk, K2_CONTRIB_OPS), library_ms=None)
    print(f"[4 K2 {name}] max abs err rgb {float(e_rgb.max()):.3g} depth "
          f"{float(e_d.max()):.3g} T {float(e_t.max()):.3g} | {bad}/{n_pix} "
          f"px beyond rgb {RGB_TOL} / depth {DEPTH_TOL} | all px within "
          f"stop-flip bound: {within} | walked, kept, contributing share of "
          f"pair-pixels {walk_shares(walk, r.total * pix)} | kernel "
          f"{k2_ms:.4f} ms, plain {k2_plain_ms:.2f} ms, bound "
          f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}) | {card}", flush=True)
    if bad > BAD_FRACTION * n_pix or not within:
        fail(f"K2 disagrees with its plain version on {name}")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    g = torch.randn(out_k.shape, generator=gen, device=DEVICE)
    g[:, 5:] = 0.0
    check_k3(torch, card, f"5 K3 {name}",
             (attrs, seg_start, counts, out_k, g, tiles_x, tiles_y, TILE,
              TILE), gid, params.capacity)
    return k1, k2


def check_k3(torch, card, label, k3_args, gid, n_gauss):
    """K3 against its plain version on ``k3_args`` (attrs, seg_start,
    counts, tiles8, g_tiles8, tiles_x, tiles_y, tile_h, tile_w), pair by
    pair and, through ``gid`` (the gaussian of each pair), gaussian by
    gaussian; fails on a breach, else returns K3's record for the kernels
    line (launches filled in later)."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (composite,
                                                            composite_cuda)

    attrs, seg_start, counts, _, _, *size = k3_args
    flip_t = composite.T_STOP / (1.0 - composite.ALPHA_MAX)
    with torch.no_grad():
        d_k = composite_cuda.composite_bwd(*k3_args)
        again = composite_cuda.composite_bwd(*k3_args)
        d_p = composite.composite_segments_bwd(*k3_args)
    if not torch.isfinite(d_k).all() or d_k[:, 10:].any():
        fail(f"K3 rows not finite, or rows 10-15 not 0, at {label}")
    if not torch.equal(d_k, again):
        fail(f"K3 does not repeat bit for bit at {label}")

    def compare(got, want):
        """(max abs err per row, share beyond the bar, all within the
        flip allowance) over rows 0-9."""
        got, want = got[:, :10], want[:, :10]
        err = (got - want).abs()
        share = float((err > grad_bar(want, 0)).any(dim=1).float().mean())
        # A flipped gate or stop decision at one pixel moves a row by at
        # most one pixel's term, whose weight is <= T_in <= T_STOP /
        # (1 - 0.99) = 1e-2 of the row's scale.
        within = bool((err <= flip_t * want.abs().amax(dim=0)
                       + grad_bar(want, 0)).all())
        return err.amax(dim=0), share, within

    e_rows, share, within = compare(d_k, d_p)
    # The gather's backward: pair rows summed into their gaussians.
    hit = torch.zeros(n_gauss, dtype=torch.bool, device=DEVICE)
    hit[gid] = True

    def per_gaussian(d):
        return torch.zeros((n_gauss, d.shape[1]), device=DEVICE).index_add_(
            0, gid, d)[hit]

    e_gauss, share_g, within_g = compare(per_gaussian(d_k),
                                         per_gaussian(d_p))
    k3_ms = cuda_ms(torch, lambda: composite_cuda.composite_bwd(*k3_args),
                    5)
    with torch.no_grad():
        k3_plain_ms = cuda_ms(
            torch, lambda: composite.composite_segments_bwd(*k3_args), 1)
    tiles_x, tiles_y, th, tw = size
    n_tiles, pix = tiles_x * tiles_y, th * tw
    n_pairs = attrs.shape[0]
    walk = walk_counts(torch, attrs, seg_start, counts, size)
    t_bytes = (n_pairs * 64 * 2 + n_tiles * 16
               + n_tiles * pix * 2 * 32) / HBM_BYTES_PER_S
    k3 = dict(max_abs_err=float(e_rows.max()), ms=k3_ms,
              plain_ms=k3_plain_ms, **bound(t_bytes, walk, K3_CONTRIB_OPS),
              library_ms=None)
    print(f"[{label}] pairs={n_pairs} in {n_tiles} {th}x{tw} tiles (max "
          f"{int(counts.max())} per tile) | max abs err per row "
          f"{[float(f'{e:.3g}') for e in e_rows.tolist()]} | pairs beyond "
          f"{GRAD_ATOL} + {GRAD_RTOL} max|row|: {share:.3g} (within flip "
          f"allowance: {within}) | per gaussian max err "
          f"{float(e_gauss.max()):.3g}, beyond: {share_g:.3g} (within: "
          f"{within_g}) | rows 10-15 zero, repeats bit for bit | walked, "
          f"kept, contributing share of pair-pixels "
          f"{walk_shares(walk, n_pairs * pix)} | kernel {k3_ms:.4f} ms, "
          f"plain {k3_plain_ms:.2f} ms, bound {k3['bound_ms']:.4f} ms "
          f"({k3['bound_by']}) | {card}", flush=True)
    if (share > BAD_FRACTION or share_g > BAD_FRACTION or not within
            or not within_g):
        fail(f"K3 disagrees with its plain version at {label}")
    return k3


def _small_scene(device):
    from multiview_inpaint_tpu_torch.utils import synthetic
    return synthetic.make_gt_gaussians(300, seed=3, spread=1.0,
                                       device=device)


def _small_camera():
    from multiview_inpaint_tpu_torch.gs import cameras
    return cameras.make_camera(0, np.eye(3), np.array([0.0, 0.0, 3.0]),
                               fovx=0.9, fovy=0.7, width=96, height=64)


def phase_path(torch):
    """The whole render path on DEVICE against the CPU path: the images,
    and the gradients of a loss on them (through K3 on DEVICE)."""
    from multiview_inpaint_tpu_torch.gs.gaussians import PARAM_FIELDS
    from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera,
                                                            render)

    cam = _small_camera()
    bg = [0.1, 0.2, 0.3]
    target = np.random.default_rng(1).random((64, 96, 3)).astype(
        np.float32)
    for tile in ((16, 16), (8, 16)):
        outs, grads = [], []
        for dev in ("cpu", DEVICE):
            params = _small_scene(dev)
            for f in PARAM_FIELDS:
                getattr(params, f).requires_grad_(True)
            offset = torch.zeros((params.capacity, 2), device=dev,
                                 requires_grad=True)
            out = render(params, RenderCamera.from_camera(cam, dev), bg,
                         tile=tile, means2d_offset=offset, device=dev)
            loss = (((out.rgb - torch.from_numpy(target).to(dev)) ** 2)
                    .mean() + 0.1 * out.depth.mean()
                    + 0.05 * out.alpha.mean())
            loss.backward()
            outs.append(out)
            grads.append({f: getattr(params, f).grad.cpu()
                          for f in PARAM_FIELDS} | {"offset":
                                                    offset.grad.cpu()})
        a, b = outs
        e_rgb = float((a.rgb - b.rgb.cpu()).detach().abs().max())
        e_d = float((a.depth - b.depth.cpu()).detach().abs().max())
        worst = {f: round(float((grads[1][f] - g).abs().max())
                          / float(grad_bar(g)), 4)
                 for f, g in grads[0].items() if g.numel()}
        print(f"[6 path {tile[0]}x{tile[1]}] {DEVICE} vs cpu render, pairs "
              f"{b.pairs}: max abs err rgb {e_rgb:.3g} depth {e_d:.3g} | "
              f"gradient err / bar {json.dumps(worst)}", flush=True)
        if not (a.pairs == b.pairs and e_rgb <= RGB_TOL
                and e_d <= DEPTH_TOL and max(worst.values()) <= 1.0):
            fail(f"{DEVICE} render path disagrees with the cpu path")


def phase_ssim(torch):
    """SSIM on DEVICE with the TF32 switches at PyTorch's defaults (the
    port's blur must force float32 itself)."""
    import torch.nn.functional as F

    from multiview_inpaint_tpu_torch.utils import losses

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False   # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    try:
        rng = np.random.default_rng(0)
        a = rng.random((3, STEP_H, STEP_W)).astype(np.float32)
        b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(
            np.float32)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        ca, cb = ta.to(DEVICE), tb.to(DEVICE)
        self_err = abs(float(losses.ssim(ca, ca)) - 1.0)
        ramp = torch.linspace(0.2, 0.8, STEP_W, device=DEVICE)
        smooth = (ramp[None, None, :] + 0.1 * torch.sin(torch.linspace(
            0, 6, STEP_H, device=DEVICE))[None, :, None]).expand(
            3, STEP_H, STEP_W).contiguous()
        near = float(losses.ssim(smooth, smooth + 1e-3 * ramp))
        val_err = abs(float(losses.ssim(ca, cb)) - float(losses.ssim(ta,
                                                                     tb)))
        grads = []
        for x, y in ((ta, tb), (ca, cb)):
            x = x.clone().requires_grad_(True)
            losses.photometric_loss(x, y).backward()
            grads.append(x.grad.cpu())
        g_err = float((grads[1] - grads[0]).abs().max())
        g_bar = float(grad_bar(grads[0]))
        # What the same moment blur gives through cuDNN at the default
        # TF32 setting (for the record: the port does not use it).
        win = losses._gaussian_window(11, 1.5, DEVICE)
        stacked = torch.cat([ca, cb, ca * ca, cb * cb, ca * cb])[None]
        raw = F.conv2d(F.conv2d(stacked, win.reshape(1, 1, 11, 1).repeat(
            15, 1, 1, 1), padding=(5, 0), groups=15), win.reshape(
            1, 1, 1, 11).repeat(15, 1, 1, 1), padding=(0, 5), groups=15)[0]
        tf32_err = float((raw.cpu() - losses._sep_blur(
            torch.cat([ta, tb, ta * ta, tb * tb, ta * tb]),
            win.cpu())).abs().max())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    print(f"[7 ssim] tf32 cudnn=True matmul=False (defaults) | self-ssim "
          f"{STEP_W}x{STEP_H} |1-s| {self_err:.3g} | smooth near-identical "
          f"pair {near:.9f} | {DEVICE} vs cpu ssim err {val_err:.3g}, "
          f"gradient err {g_err:.3g} (bar {g_bar:.3g}) | unguarded cuDNN "
          f"blur vs fp32: {tf32_err:.3g}", flush=True)
    if self_err > 1e-6 or near > 1.0 or val_err > 1e-6 or g_err > g_bar:
        fail("SSIM on the card breaks its bounds or disagrees with the CPU")


def phase_step(torch):
    """One train step on DEVICE against the CPU train step."""
    from multiview_inpaint_tpu_torch.gs.gaussians import PARAM_FIELDS
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera

    cam = _small_camera()
    gt = np.random.default_rng(0).random((64, 96, 3)).astype(np.float32)
    cfg = gs_trainer.OptimizationConfig()
    runs = {}
    for dev in ("cpu", DEVICE):
        runs[dev] = gs_trainer.train_step(
            gs_trainer.init_state(_small_scene(dev)),
            RenderCamera.from_camera(cam, dev), torch.from_numpy(gt).to(dev),
            torch.tensor([0.1, 0.2, 0.3], device=dev), cfg, 1.0)
    (a, ma), (b, mb) = runs["cpu"], runs[DEVICE]
    loss_rel = abs(float(mb.loss) - float(ma.loss)) / abs(float(ma.loss))
    worst = {}
    ok = ma.pairs == mb.pairs and loss_rel <= 1e-5
    for f in PARAM_FIELDS:
        want = a.mu[f] / 0.1            # mu = 0.1 g at step 1
        if want.numel() == 0:
            continue
        bar = float(grad_bar(want))
        e_mu = float((b.mu[f].cpu() / 0.1 - want).abs().max())
        e_nu = float((torch.sqrt(b.nu[f].cpu() / 0.001)
                      - torch.sqrt(a.nu[f] / 0.001)).abs().max())
        worst[f] = round(max(e_mu, e_nu) / bar, 4)
        ok = ok and e_mu <= bar and e_nu <= bar
    ga = a.stats.grad_accum
    e_ga = float((b.stats.grad_accum.cpu() - ga).abs().max())
    ok = (ok and e_ga <= float(grad_bar(ga))
          and torch.equal(b.stats.denom.cpu(), a.stats.denom)
          and torch.equal(b.stats.max_radii2d.cpu(), a.stats.max_radii2d))
    print(f"[8 step] {DEVICE} vs cpu train_step, 300 splats 96x64, pairs "
          f"{mb.pairs}: loss rel err {loss_rel:.3g} | gradient (mu, nu) err "
          f"/ bar per field {json.dumps(worst)} | grad_accum err "
          f"{e_ga:.3g} | denom, max_radii2d equal", flush=True)
    if not ok:
        fail(f"{DEVICE} train step disagrees with the cpu train step")


def phase_main(torch, card):
    """Main path 1: the render CLI on the 2M-gaussian 1080p scene; returns
    the launch counts of that run."""
    from PIL import Image

    from multiview_inpaint_tpu_torch.gs import gaussians
    from multiview_inpaint_tpu_torch.ops.rasterizer import _kernels
    from multiview_inpaint_tpu_torch.pipelines import render as render_cli
    from multiview_inpaint_tpu_torch.utils import synthetic

    work = os.path.join(REPO, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    src = os.path.join(work, "scene")
    model = os.path.join(work, "model")
    names = synthetic.write_bench_colmap_scene(src, YAWS)
    ply = os.path.join(model, "point_cloud", "iteration_1",
                       "point_cloud.ply")
    gaussians.save_ply(synthetic.make_big_scene(BIG_N, device="cpu"), ply)

    _kernels.reset_launches()
    t0 = time.perf_counter()
    render_cli.main(["-s", src, "-m", model, "--resolution", "1",
                     "--skip_test", "--device", DEVICE])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    n_views = len(names)
    if launches != {"pair_expand": n_views, "composite": n_views,
                    "composite_bwd": 0}:
        fail(f"main path 1 launches {launches}, expected {n_views} each "
             f"of the forward kernels")
    out_dir = os.path.join(model, "train", "ours_1", "renders")
    pngs = sorted(os.listdir(out_dir))
    if len(pngs) != n_views:
        fail(f"{len(pngs)} PNGs written, expected {n_views}")
    for p in pngs:
        with Image.open(os.path.join(out_dir, p)) as im:
            arr = np.asarray(im)
        if arr.shape != (1080, 1920, 3) or arr.std() == 0:
            fail(f"{p}: shape {arr.shape}, constant={arr.std() == 0}")

    print(f"[9 main render] render CLI, {BIG_N} gaussians, {n_views} views "
          f"at 1920x1080 in {cli_s:.1f} s (PNGs written) | "
          f"launches {launches} | {card}", flush=True)
    frame_times(torch, card, f"big2m ({BIG_N} gaussians, from the PLY)",
                gaussians.load_ply(ply, 0, device=DEVICE))
    frame_times(torch, card, f"ball100k ({BALL_N} gaussians)",
                synthetic.make_bench_ball(BALL_N, device=DEVICE))
    return launches


def frame_times(torch, card, name, params):
    """Median device ms/frame of ``render`` over the YAWS views (CUDA
    events, after one warm-up view) and the per-stage split of the bench
    view; fails on a frame that is not finite or is constant."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera,
                                                            render)
    from multiview_inpaint_tpu_torch.utils import synthetic

    cams = [RenderCamera.from_camera(synthetic.bench_camera(y), DEVICE)
            for y in YAWS]
    bg = torch.zeros(3, device=DEVICE)
    times, pairs = [], []
    with torch.no_grad():
        render(params, cams[0], bg, device=DEVICE)          # warm-up view
        torch.cuda.synchronize()
        for c in cams:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = render(params, c, bg, device=DEVICE)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            pairs.append(out.pairs)
            if not (torch.isfinite(out.rgb).all()
                    and torch.isfinite(out.depth).all()
                    and float(out.rgb.std()) > 0):
                fail(f"{name}: frame not finite or constant")
    print(f"[9 frame {name}] median {statistics.median(times):.3f} "
          f"ms/frame over {len(times)} views at 1920x1080 (CUDA events, "
          f"after one warm-up view; all {[round(t, 3) for t in times]}; "
          f"pairs {pairs}) | {card}", flush=True)
    split = stage_split(torch, params, cams[0])
    print(f"[9 stages {name}] ms per stage of the bench view: "
          f"{json.dumps({k: round(v, 4) for k, v in split.items()})} | "
          f"{card}", flush=True)


def stage_split(torch, params, cam):
    """Device ms of each step of ``api.render`` for one frame, timed with
    CUDA events (mean of 3 frames after a warm-up frame)."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        api, binning, composite_cuda, pair_expand)
    tiles_x, tiles_y = -(-cam.width // TILE), -(-cam.height // TILE)
    names = ("project", "rects_compact", "K1_pair_keys", "sort",
             "segments", "gather_attrs", "K2_composite", "assemble")
    totals = dict.fromkeys(names, 0.0)
    frames = 3
    for it in range(frames + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
        with torch.no_grad():
            ev[0].record()
            proj = api.project(params, cam, 0)
            ev[1].record()
            r = binning.compact_rects(proj.means2d, proj.radius, proj.depth,
                                      tiles_x, tiles_y, TILE, TILE,
                                      proj.extent)
            ev[2].record()
            keys = pair_expand.expand_keys(r.starts, r.x0, r.y0, r.w,
                                           r.count, r.n_active, r.total,
                                           tiles_x)
            ev[3].record()
            keys = torch.sort(keys).values
            ev[4].record()
            counts, seg_start = binning.segments_from_keys(
                keys, tiles_x * tiles_y)
            ev[5].record()
            attrs = composite_cuda.pack_attrs(
                proj.means2d, proj.conic, proj.opacity, proj.color,
                proj.depth)[r.order[keys & 0xFFFFFFFF]]
            ev[6].record()
            t8 = composite_cuda.composite(attrs, seg_start, counts, tiles_x,
                                          tiles_y, TILE, TILE)
            ev[7].record()
            api.assemble(t8.transpose(1, 2), tiles_x, tiles_y, TILE, TILE,
                         cam.width, cam.height).contiguous()
            ev[8].record()
        torch.cuda.synchronize()
        if it:
            for i, n in enumerate(names):
                totals[n] += ev[i].elapsed_time(ev[i + 1]) / frames
    return totals


class StepProbe:
    """Times the real ``gs_trainer.train_step`` by parts and keeps its K3
    call.

    ``step`` runs one train step with wrappers around what the step
    calls: ``render``, ``loss_terms`` and ``apply_adam`` in
    ``gs_trainer``, and under the render the pair binning (to keep each
    pair's gaussian), ``pack_attrs`` (a gradient hook on its output marks
    the end of the gather's backward) and K3's wrapper (its inputs are
    kept). Each boundary records a CUDA event.
    """
    MARKS = ("step", "render", "loss", "k3_in", "k3_out", "gather",
             "adam_in", "adam_out")
    PARTS = ("render_fwd", "loss_fwd", "bwd_loss_assemble", "bwd_K3",
             "bwd_gather", "bwd_projection", "adam")

    def __init__(self, torch):
        from multiview_inpaint_tpu_torch.models import gs_trainer
        from multiview_inpaint_tpu_torch.ops.rasterizer import (
            api, binning, composite_cuda)
        self.torch, self.ev, self.k3_args, self.gid = torch, {}, None, None

        def marked(fn, first, last):
            def run(*a, **kw):
                if first:
                    self.mark(first)
                out = fn(*a, **kw)
                self.mark(last)
                return out
            return run

        def bins(*a, **kw):
            b = bin_gaussians(*a, **kw)
            self.gid = b.order[b.gid_sorted]
            return b

        def pack(*a):
            packed = pack_attrs(*a)
            if packed.requires_grad:
                packed.register_hook(lambda g: self.mark("gather"))
            return packed

        def k3(*a):
            self.k3_args = a
            return k3_marked(*a)

        bin_gaussians, pack_attrs = binning.bin_gaussians, api.pack_attrs
        k3_marked = marked(composite_cuda.composite_bwd, "k3_in", "k3_out")
        self.patches = [
            (gs_trainer, "render", marked(gs_trainer.render, None, "render")),
            (gs_trainer, "loss_terms",
             marked(gs_trainer.loss_terms, None, "loss")),
            (gs_trainer, "apply_adam",
             marked(gs_trainer.apply_adam, "adam_in", "adam_out")),
            (binning, "bin_gaussians", bins), (api, "pack_attrs", pack),
            (composite_cuda, "composite_bwd", k3)]

    def mark(self, key):
        self.ev[key] = self.torch.cuda.Event(enable_timing=True)
        self.ev[key].record()

    def step(self, *args):
        """``gs_trainer.train_step(*args)`` with the wrappers in place;
        returns its result and the device ms of each of ``PARTS``."""
        from multiview_inpaint_tpu_torch.models import gs_trainer
        saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for m, n, f in self.patches:
            setattr(m, n, f)
        try:
            self.mark("step")
            out = gs_trainer.train_step(*args)
            self.torch.cuda.synchronize()
        finally:
            for m, n, f in saved:
                setattr(m, n, f)
        return out, {p: self.ev[a].elapsed_time(self.ev[b]) for p, a, b in
                     zip(self.PARTS, self.MARKS, self.MARKS[1:])}


def phase_train(torch, card, iterations=TRAIN_ITERS, extra=()):
    """Main path 2: one train step of the orbit scene (K3 held against its
    plain version there), then the train_gs CLI on that scene, with
    ``extra`` CLI arguments; returns the launch counts of the CLI run and
    K3's record for the kernels line."""
    from multiview_inpaint_tpu_torch.gs.scene import Scene
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera,
                                                            _kernels)
    from multiview_inpaint_tpu_torch.pipelines import train_gs
    from multiview_inpaint_tpu_torch.utils import synthetic

    work = os.path.join(REPO, "build", "smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    src = os.path.join(work, "scene")
    model = os.path.join(work, "model")
    t0 = time.perf_counter()
    names = synthetic.write_orbit_colmap_scene(
        src, synthetic.make_big_scene(BIG_N, device=DEVICE),
        np.linspace(-0.35, 0.35, TRAIN_VIEWS), TRAIN_W, TRAIN_H,
        TRAIN_POINTS)
    scene_s = time.perf_counter() - t0

    # The CLI's first step: its scene, init and loss, on one of its views.
    scene = Scene(src, os.path.join(work, "first_step"), resolution=1,
                  device=DEVICE)
    cam = scene.train_cameras()[0]
    probe = StepProbe(torch)
    (state, _), _ = probe.step(
        gs_trainer.init_state(scene.gaussians),
        RenderCamera.from_camera(cam, DEVICE),
        torch.as_tensor(np.asarray(cam.image, np.float32), device=DEVICE),
        torch.zeros(3, device=DEVICE), gs_trainer.OptimizationConfig(),
        scene.cameras_extent)
    k3 = check_k3(torch, card, "10 K3 orbit-train first step",
                  probe.k3_args, probe.gid, state.params.capacity)
    seen = state.stats.denom > 0
    threshold = float(torch.quantile(state.stats.grad_accum[seen],
                                     DENSIFY_QUANTILE))
    capacity = TRAIN_POINTS + TRAIN_SPARE_ROWS
    del scene, probe, state

    _kernels.reset_launches()
    t0 = time.perf_counter()
    train_gs.main([
        "-s", src, "-m", model, "--resolution", "1",
        "--iterations", str(iterations), "--densify_from_iter", "20",
        "--densify_until_iter", "50", "--densification_interval", "20",
        "--densify_grad_threshold", repr(threshold),
        "--capacity", str(capacity), "--opacity_reset_interval", "100000",
        "--test_iterations", str(iterations),
        "--save_iterations", str(iterations),
        "--checkpoint_iterations", str(iterations), "--log_interval", "10",
        "--device", DEVICE, *extra,
    ])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)

    with open(os.path.join(model, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    steps = [r for r in log if "loss" in r]
    densified = [r for r in log if "wanted" in r]
    evals = [r for r in log if "psnr" in r]
    n_eval = min(5, len(names))          # the CLI's report renders
    ply = os.path.join(model, "point_cloud", f"iteration_{iterations}",
                       "point_cloud.ply")
    ckpt = os.path.join(model, f"chkpnt{iterations}.npz")
    last = steps[-1] if steps else {}
    checks = {
        "loss falls": bool(steps) and steps[-1]["loss"] < steps[0]["loss"],
        "densify ran twice": [r["step"] for r in densified] == [20, 40],
        "densify wrote rows": bool(densified) and
        densified[0]["cloned"] + densified[0]["split"] > 0,
        "capacity grew": last.get("capacity", 0) > capacity,
        "PLY and npz written": os.path.exists(ply) and os.path.exists(ckpt),
        "no non-finite gradient": all(r["nonfinite_grads"] == 0
                                      for r in steps),
        "K3 once per step": launches["composite_bwd"] == iterations,
        "K1, K2 once per render": launches["composite"]
        == launches["pair_expand"] == iterations + n_eval,
    }
    densify = [{k: r[k] for k in ("step", "cloned", "split", "pruned",
                                  "wanted", "granted")} for r in densified]
    print(f"[10 main train] train_gs CLI, {iterations} iterations on "
          f"{len(names)} views at {TRAIN_W}x{TRAIN_H} (GT rendered from "
          f"{BIG_N} gaussians, {TRAIN_POINTS} init points in {capacity} "
          f"rows; scene written in {scene_s:.1f} s) in {cli_s:.1f} s | loss "
          f"{[round(r['loss'], 5) for r in steps]} | points "
          f"{last.get('points')} capacity {last.get('capacity')} pairs "
          f"{last.get('pairs')} | densify threshold {threshold:.4g} (the "
          f"{DENSIFY_QUANTILE} quantile of the first step), {densify} | "
          f"psnr {[round(r['psnr'], 3) for r in evals]} | launches "
          f"{launches} | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 2 (train CLI) checks failed: {checks}")
    return launches, k3


def phase_step_time(torch, card):
    """The train step at full width: median ms/step, the split of the
    real step (mean of 3 probed steps) and its K3 call against the plain
    K3."""
    from multiview_inpaint_tpu_torch.gs import cameras
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera
    from multiview_inpaint_tpu_torch.utils import synthetic

    params = synthetic.make_bench_ball(STEP_N, capacity=STEP_CAPACITY,
                                       device=DEVICE)
    cam = RenderCamera.from_camera(cameras.make_camera(
        0, np.eye(3), np.array([0.0, 0.0, 3.0]), fovx=1.1, fovy=0.8,
        width=STEP_W, height=STEP_H), DEVICE)
    gt = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (STEP_H, STEP_W, 3)).astype(np.float32)).to(DEVICE)
    bg = torch.zeros(3, device=DEVICE)
    cfg = gs_trainer.OptimizationConfig()
    state = gs_trainer.init_state(params)
    times = []
    for it in range(12):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = gs_trainer.train_step(state, cam, gt, bg, cfg, 1.0)
        end.record()
        torch.cuda.synchronize()
        if it >= 2:
            times.append(start.elapsed_time(end))
        if not torch.isfinite(m.loss) or int(m.nonfinite_grads):
            fail("full-width train step: loss or gradients not finite")
    parts = []
    for _ in range(3):
        probe = StepProbe(torch)
        (state, m), ms = probe.step(state, cam, gt, bg, cfg, 1.0)
        parts.append(ms)
    split = {p: statistics.mean(ms[p] for ms in parts)
             for p in StepProbe.PARTS}
    print(f"[11 step time] {STEP_N} gaussians in {STEP_CAPACITY} rows at "
          f"{STEP_W}x{STEP_H}, pairs {m.pairs}: median "
          f"{statistics.median(times):.3f} ms/step over {len(times)} steps "
          f"(CUDA events, after 2 warm-up steps; all "
          f"{[round(t, 3) for t in times]}) | split of the step (ms, mean "
          f"of 3 steps): "
          f"{json.dumps({k: round(v, 4) for k, v in split.items()})} | "
          f"{card}", flush=True)
    check_k3(torch, card, "11 K3 ball2m-train step", probe.k3_args,
             probe.gid, state.params.capacity)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this script measures the GPU port "
             "and has no CPU fallback")
    sys.path.insert(0, REPO)
    from multiview_inpaint_tpu_torch.utils import synthetic

    t_start = time.perf_counter()
    card = phase_card(torch)
    phase_build()
    frames = {}
    for name, make in (("ball100k", synthetic.make_bench_ball),
                       ("big2m", synthetic.make_big_scene)):
        n = BALL_N if name == "ball100k" else BIG_N
        frames[name] = phase_kernels(torch, card, name,
                                     make(n, device=DEVICE))
    phase_path(torch)
    phase_ssim(torch)
    phase_step(torch)
    launches = phase_main(torch, card)
    launches_train, k3 = phase_train(torch, card)
    phase_step_time(torch, card)

    k1, k2 = frames["big2m"]   # the render main path's scene and shapes
    kernels = [
        dict(name="pair_expand", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/pair_expand.cu",
             replaces="multiview_inpaint_tpu/ops/rasterizer/"
                      "pair_expand.py:92",
             launches=launches["pair_expand"], **k1),
        dict(name="composite", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/composite.cu",
             replaces="multiview_inpaint_tpu/ops/rasterizer/"
                      "pallas_composite.py:75",
             launches=launches["composite"], **k2),
        # K3 at the first step of main path 2, the path that runs it.
        dict(name="composite_bwd", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/composite_bwd.cu",
             replaces="multiview_inpaint_tpu/ops/rasterizer/"
                      "pallas_backward.py:54",
             launches=launches_train["composite_bwd"], **k3),
    ]
    print(f"[12 done] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
