#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Drives ``multiview_inpaint_tpu_torch`` only (never JAX, never the JAX
package), phase by phase, one line each; any failure raises and exits
non-zero:

1. the card (``nvidia-smi`` name and power limit), torch, TF32 settings
   (both TF32 switches are set off, so the plain versions run in fp32;
   phase 7 puts them back to PyTorch's defaults for its own checks);
2. build the CUDA kernels from ``multiview_inpaint_tpu_torch/csrc``, and
   print each flash kernel's registers, spills (ptxas) and dynamic shared
   memory, and any ptxas warning or performance note about them, K2's
   and K3's registers, spills and static shared memory (ptxas), and K3's
   blocks per SM and splats per warp reduction;
3. K1 (pair keys) against its plain version, bit for bit, on the 1080p
   bench frames of the 100k bench ball and the 2M-gaussian scene;
4. K2 (composite) against its plain version on the same frames: max
   errors, pixels beyond rgb 3e-5 / depth 3e-4 (at most 0.01%), every
   pixel within the stop-flip bound; its tiles bit-equal with and without
   the per-item state output, and that state against the plain K2's at
   the same bars over every item-pixel (``compare_state``);
5. K3 (composite backward), started from K2's per-item state, against
   its plain version walking each tile from its start and against its
   plain version from the same state, on the same frames under a
   seeded cotangent (``check_k3``, which also prints the tile depths, the
   work items and the walked, kept and contributing shares of
   pair-pixels): max error per row, pairs
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
    gradient norms), and K2 on its inputs timed with and without the
    per-item state (tiles and state bit-equal to the step's, the state
    against the plain K2's as in phase 4); then the
    ``train_gs`` CLI for 60 iterations in a
    buffer a little larger than the init, counters zeroed before and read
    after: loss falls, densify ran twice and wrote rows, the capacity
    grew, PLY and npz written, no non-finite gradient, K3 launched once
    per step;
11. the train step at full width: the 2M-gaussian bench ball in a
    2,097,152-row buffer at 512x384, median ms/step over 10 steps after
    2 warm-up steps (CUDA events), the split of the real step into render
    forward, loss, backward (loss/assembly, K3, the gather's backward, the
    projection's backward) and Adam (``StepProbe``), and its K3 call held
    against the plain K3 as in phase 5; then a planted fault (``k3_fault``:
    K3 fed the next item's state for the first item of the deepest tile)
    that the same bar must fail;
12. K4 (flash-attention forward) against its plain version as main path
    3 calls it, on the packed [B, T, H*D] projections: [28, 3072, 5*64]
    with 5 heads (ds1) and [28, 768, 10*64] with 10 heads (ds2) in bf16,
    and [2, 768, 64] in f32: max abs error (0.02) and relative to
    max|plain| (0.02), bit-equal on a second run and equal to K4 on the
    folded [B*H, T, D] layout, kernel, plain and bound ms, achieved
    TFLOP/s, and PyTorch's ``scaled_dot_product_attention`` timed as a
    yardstick (the port never calls it) with the kernel/SDPA factor;
13. the tiny SVD engine (``svd_test --tiny_model``, 3 frames at 64x48)
    on CUDA against the CPU with the same weights (every all-zero
    parameter moved) and noise, f32 with TF32 off: conditioning, one
    guided denoiser evaluation, a 2-step sample (bounded by the f32
    spacing at its first step's start) and the decoding of one set of
    latents on both;
14. main path 3: the ``svd_test`` CLI at full width (VideoUNet 320,
    ControlNet, VAE, ViT-H CLIP: 2.9B random bf16 parameters made on the
    card, every all-zero one moved) on a synthetic gs/ tree, 14 frames at
    512x384, 25 Euler-EDM steps at CFG batch 28, counters zeroed before:
    14 finite frames written and K4 launched exactly 350 times; seconds
    per clip split into conditioning, the median sampler step and the
    VAE decode (``SvdProbe``), peak device memory per part;
15. one full-width guided denoiser evaluation at sigma_max, its q and k
    projections scaled so that the attention is far from uniform, through
    K4, then with ``attention_op``'s K4 call patched to the plain version
    (0 launches), against a bf16 bar that lies below what two planted K4
    faults (a dropped key tile, a softmax in the wrong exponent base)
    move (relative rms of the difference) and at most a tenth of what a
    change of noise seed moves;
16. K5 (flash-attention backward) against its plain version as main path
    4 calls it, on the packed projections of one video, [14, 3072, 5*64]
    (ds1) and [14, 768, 10*64] (ds2) bf16, and [2, 768, 64] f32, with o and
    the logsumexp from K4 and a seeded cotangent: dq, dk, dv within 0.02
    of max|plain| and 0.01 relative rms, bit-equal on a second run; kernel,
    plain and bound ms, achieved TFLOP/s, and the backward of PyTorch's
    ``scaled_dot_product_attention`` timed as a yardstick (never called by
    the port) with the kernel/SDPA factor;
17. the gradient of one full-width ds1 SpatialVideoTransformer (320
    channels, 5 heads, 14 frames at 64x48, bf16, q and k scaled x3 as in
    phase 15) through K4 + K5 against the same block with
    ``flash_attention.FlashAttention`` patched to the plain forward and
    backward, and to two planted K5 faults (no delta term; the
    first 64-key tile's contribution dropped): relative rms of the input
    and parameter gradients, a bar the faults exceed;
18. one train step of the tiny SVD engine (``svd_train --tiny_model``, 3
    frames at 64x48, f32, TF32 off) on CUDA against the CPU with the same
    weights, draws and data: loss, every ControlNet gradient and the
    parameters after the Adam step;
19. main path 4: the ``svd_train`` CLI at full width (``EngineConfig()``'s
    networks, 2.9B random bf16 parameters with every all-zero one moved,
    bf16 compute and parameters, 14 frames at 512x384, batch 1, ``--ema``)
    for a few steps on a ``write_est_tree`` tree, counters zeroed before:
    K5 and K4 launched exactly 10 and 14 times per step, finite losses,
    the UNet, VAE and CLIP bit-unchanged and the ControlNet moved, the EMA
    checkpoint written and read back equal; step time, peak device memory,
    the checkpoint's save time and the share of ControlNet entries the
    first bf16 Adam step changed;
20. the ``kernels`` JSON line (K1 and K2 at main path 1's big2m frame, K3
    at main path 2's first step, K4 at main path 3's ds1 shape, K5 at main
    path 4's ds1 shape; K4 and K5 also carry ``vs_library``, kernel ms over
    SDPA ms); the last line is the ``ok`` JSON object.

Build outputs and the scenes go under ``build/`` in the checkout.
"""

import ctypes
import json
import math
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
# Main path 3 (the svd_test CLI at full width): 14 frames at 512x384, 25
# Euler-EDM steps, the uc|c batch of 28 frames per denoiser evaluation.
SVD_FRAMES, SVD_STEPS, SVD_H, SVD_W = 14, 25, 512, 384
# K4 as the main path calls it: (B, T, heads, D, dtype) of the packed
# [B, T, H*D] projections of the ds1 and ds2 spatial self-attention (5 and
# 10 heads of 64 over the 28 frames), and once in f32. Bars: the JAX
# kernel test's 0.02 max abs at unit-normal inputs, and 0.02 of
# max|plain| (p, and f32 inputs, rounded to bf16).
K4_SHAPES = ((28, 3072, 5, 64, "bfloat16"), (28, 768, 10, 64, "bfloat16"),
             (2, 768, 1, 64, "float32"))
K4_ABS_TOL = K4_REL_TOL = 0.02
K4_PER_EVAL = 14        # ds1 and ds2 blocks: 10 in the UNet, 4 in the trunk
BF16_FLOP_PER_S = 989e12
# The denoiser evaluation through K4 against the plain attention: the rms
# of the difference at most this share of the rms of the plain output.
# The q and k projections are scaled by SVD_QK_GAIN first: at init the
# logits have a std of ~0.33 and the attention is near uniform, so that
# its output is about the mean of v whatever K4 does; x3 on each makes it
# ~3. The bar lies between the sound reading (0.0140 on an H100) and the
# smaller of two planted K4 faults' (0.0237: the first key tile dropped;
# 0.0411: an exp2 softmax without log2 e), near their geometric mean, and
# is at most a tenth of what a change of noise seed moves.
SVD_EVAL_RMS_TOL = 0.018
SVD_QK_GAIN = 3.0
# The tiny engine in f32, CUDA against the CPU: the conditioning, one
# denoiser evaluation and the decoding of one set of latents at 1e-4 of
# their largest magnitude (sums in another order). The 2-step sample's
# first Euler step, x0 + (sigma1 - sigma0) * (x0 - D) / sigma0, cancels
# x0 = 700 * noise (~2000) down to the denoised latents D (~1). Its
# subtraction, division and product each round at the scale of x0 (half
# an f32 spacing at max|x0|, 0.68 of one for the division, whose result is
# 700 times smaller), and a denoiser difference of 1e-5 can flip each of
# those roundings: each latent may differ between the two devices by 4
# spacings of f32 at its own |x0| besides 1e-4 of max|latents|.
SVD_F32_REL_TOL, SVD_X0_ULPS = 1e-4, 4
# K5 as main path 4 calls it: the packed projections of one video (the
# training batch of 14 frames) at ds1 and ds2, and once in f32. Bars: 0.02
# of max|plain| (K4's) and 0.01 relative rms (bf16 rounding of p and ds,
# and of every operand for f32 inputs).
K5_SHAPES = ((14, 3072, 5, 64, "bfloat16"), (14, 768, 10, 64, "bfloat16"),
             (2, 768, 1, 64, "float32"))
K5_REL_TOL, K5_RMS_TOL = 0.02, 0.01
# Main path 4 (the svd_train CLI at full width): scenes of 14 frames at
# 512x384, one epoch of one step per scene, batch 1. Per step, K5 runs on
# every long self-attention with a gradient (the ControlNet trunk's 2 + 2
# ds1/ds2 blocks and the UNet decoder's 3 + 3) and K4 on those and the
# UNet encoder's 2 + 2 (no gradient there: its inputs carry none).
TRAIN_SVD_SCENES = 4
K5_PER_STEP, K4_PER_TRAIN_STEP = 10, 14
# The full-width transformer gradient through K4 + K5 against the plain
# forward and backward: relative rms of the difference of all gradients
# (input and parameters) at most this. The bar lies between the sound
# reading (0.0044 on an H100) and the smaller of two planted K5 faults'
# (0.0299: the first key tile dropped; 0.168: no delta term), near their
# geometric mean.
K5_GRAD_RMS_TOL = 0.012
# The planted faults of phases 15 and 17 drop the first 64 keys, the tile
# against which their bars were set, whatever tile the kernels use.
FAULT_KEYS = 64


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
    """Builds the kernels; prints each kernel's registers and spills
    (ptxas), the flash kernels' dynamic and the composite kernels' static
    shared memory, and K3's blocks per SM and splats per reduction."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    t0 = time.perf_counter()
    lib_path = _kernels.build()
    lib = _kernels.library()
    print(f"[2 build] {os.path.relpath(lib_path, REPO)} from "
          f"{', '.join(_kernels.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    smem = {"flash_fwd_kernel": lambda dp: lib.mvi_flash_attn_fwd_smem(dp),
            "flash_bwd_dkdv_kernel": lambda dp: lib.mvi_flash_attn_bwd_smem(
                0, dp),
            "flash_bwd_dq_kernel": lambda dp: lib.mvi_flash_attn_bwd_smem(
                1, dp)}
    for src in ("flash_attn_fwd.cu", "flash_attn_bwd.cu"):
        for name, regs, st, ld, _ in _kernels.ptxas_report(src):
            kind = next(k for k in smem if k in name)
            dp = 128 if "Li128E" in name else 64
            out = "f32" if "IfLi" in name else "bf16"
            print(f"[2 build] {kind}<{out} out, D padded to {dp}>: {regs} "
                  f"registers, {smem[kind](dp)} bytes dynamic shared "
                  f"memory, spill stores {st} B, spill loads {ld} B",
                  flush=True)
        log = _kernels.BUILD_DIR / (src[:-3] + ".ptxas.txt")
        for line in (log.read_text().splitlines() if log.exists() else ()):
            if "warning" in line.lower() or "Performance" in line:
                print(f"[2 build] {src}: {line.strip()}", flush=True)
    for src in ("composite.cu", "composite_bwd.cu"):
        for name, regs, st, ld, sm in _kernels.ptxas_report(src):
            print(f"[2 build] {name}: {regs} registers, {sm} bytes static "
                  f"shared memory, spill stores {st} B, spill loads {ld} B",
                  flush=True)
    res = (ctypes.c_int * 2)()
    _kernels.check(lib.mvi_composite_bwd_residency(TILE * TILE, res),
                   "composite_bwd_kernel residency")
    print(f"[2 build] K3 composite_bwd_kernel: {res[0]} blocks of "
          f"{TILE * TILE} threads per SM, {res[1]} splats per warp "
          f"reduction", flush=True)


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
        out_s, state = composite_cuda.composite_fwd(*k2_args,
                                                    with_state=True)
        out_p, state_p = composite.composite_segments(*k2_args,
                                                      with_state=True)
    if not (torch.isfinite(out_k).all() and torch.isfinite(out_p).all()):
        fail(f"K2 output not finite on {name}")
    if not torch.equal(out_k, out_s):
        fail(f"K2's tiles differ with the per-item state output on {name}")
    state_note = compare_state(torch, f"4 K2 {name}", attrs, counts, state,
                               state_p)

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
          f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}) | {state_note} | "
          f"{card}", flush=True)
    if bad > BAD_FRACTION * n_pix or not within:
        fail(f"K2 disagrees with its plain version on {name}")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    g = torch.randn(out_k.shape, generator=gen, device=DEVICE)
    g[:, 5:] = 0.0
    check_k3(torch, card, f"5 K3 {name}",
             (attrs, seg_start, counts, out_k, g, tiles_x, tiles_y, TILE,
              TILE, state), gid, params.capacity)
    return k1, k2


def compare_state(torch, label, attrs, counts, state_k, state_p):
    """K2's per-item state ``state_k`` against the plain K2's ``state_p``
    over the frame's items, at K2's bars: T and the rgb accumulators
    within 3e-5, the depth accumulator within 3e-4, at all but 0.01% of
    item-pixels, and every item-pixel within the stop-flip bound (a
    flipped stop moves the carry by at most T_in <= 1e-2 of a splat's
    colour or depth). Fails on a breach, else returns the summary."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite

    n_items = int(composite.item_ends(counts)[-1]) if counts.numel() else 0
    got, want = state_k[:n_items], state_p[:n_items]
    e_t = (got[:, 0] - want[:, 0]).abs()
    e_rgb = (got[:, 1:4] - want[:, 1:4]).abs().amax(1)
    e_d = (got[:, 4] - want[:, 4]).abs()
    flip_t = composite.T_STOP / (1.0 - composite.ALPHA_MAX)
    c_max = float(attrs[:, 6:9].abs().max()) if attrs.shape[0] else 0.0
    d_max = float(attrs[:, 9].abs().max()) if attrs.shape[0] else 0.0
    bad = int(((e_t > RGB_TOL) | (e_rgb > RGB_TOL) | (e_d > DEPTH_TOL))
              .sum())
    within = bool((e_t <= flip_t + RGB_TOL).all()
                  and (e_rgb <= flip_t * c_max + RGB_TOL).all()
                  and (e_d <= flip_t * d_max + DEPTH_TOL).all())
    note = (f"per-item state of {n_items} items vs plain: max abs err T "
            f"{float(e_t.max()) if n_items else 0.0:.3g} rgb "
            f"{float(e_rgb.max()) if n_items else 0.0:.3g} depth "
            f"{float(e_d.max()) if n_items else 0.0:.3g}, {bad}/"
            f"{e_t.numel()} item-px beyond, all within the stop-flip "
            f"bound: {within}")
    if bad > BAD_FRACTION * e_t.numel() or not within:
        fail(f"K2's per-item state disagrees with the plain K2's at {label}:"
             f" {note}")
    return note


def compare_k3(torch, d_k, d_p, gid, n_gauss):
    """K3's rows ``d_k`` against the plain K3's ``d_p`` over rows 0-9,
    pair by pair and, through ``gid`` (the gaussian of each pair),
    gaussian by gaussian: (max abs err per row, share of pairs beyond the
    bar, all pairs within the flip allowance, the same three per
    gaussian, whether all of it holds)."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite

    flip_t = composite.T_STOP / (1.0 - composite.ALPHA_MAX)

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

    # The gather's backward: pair rows summed into their gaussians.
    hit = torch.zeros(n_gauss, dtype=torch.bool, device=DEVICE)
    hit[gid] = True

    def per_gaussian(d):
        return torch.zeros((n_gauss, d.shape[1]), device=DEVICE).index_add_(
            0, gid, d)[hit]

    e_rows, share, within = compare(d_k, d_p)
    e_gauss, share_g, within_g = compare(per_gaussian(d_k),
                                         per_gaussian(d_p))
    ok = (share <= BAD_FRACTION and share_g <= BAD_FRACTION and within
          and within_g)
    return e_rows, share, within, e_gauss, share_g, within_g, ok


def depth_stats(torch, counts):
    """The tile depth distribution the composite kernels see: pairs per
    non-empty tile (mean, max), the work items and the tiles cut into
    more than one."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite
    busy = counts[counts > 0].double()
    n_items = composite.item_ends(counts)
    return (f"{int(busy.numel())} non-empty tiles, mean "
            f"{float(busy.mean()) if busy.numel() else 0.0:.1f} max "
            f"{int(counts.max())} pairs | {int(n_items[-1])} items of <= "
            f"{composite.ITEM_PAIRS} pairs ("
            f"{int((counts > composite.ITEM_PAIRS).sum())} tiles split; "
            f"grid {composite.max_items(counts.numel(), int(counts.sum()))})")


def check_k3(torch, card, label, k3_args, gid, n_gauss):
    """K3 against its plain version on ``k3_args`` (attrs, seg_start,
    counts, tiles8, g_tiles8, tiles_x, tiles_y, tile_h, tile_w, the
    forward's per-item state), pair by pair and gaussian by gaussian
    (``compare_k3``), twice: against the plain K3 walking each tile from
    its start, which owes nothing to K2's state, and against the plain
    K3 started from that state. Fails on a breach of either, else returns
    K3's record for the kernels line (launches filled in later)."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (composite,
                                                            composite_cuda)

    attrs, seg_start, counts, _, _, *size, _ = k3_args
    with torch.no_grad():
        d_k = composite_cuda.composite_bwd(*k3_args)
        again = composite_cuda.composite_bwd(*k3_args)
        d_walk = composite.composite_segments_bwd(*k3_args[:-1])
        d_p = composite.composite_segments_bwd(*k3_args)
    if not torch.isfinite(d_k).all() or d_k[:, 10:].any():
        fail(f"K3 rows not finite, or rows 10-15 not 0, at {label}")
    if not torch.equal(d_k, again):
        fail(f"K3 does not repeat bit for bit at {label}")
    e_walk, share_w, within_w, e_gauss_w, share_gw, within_gw, ok_w = (
        compare_k3(torch, d_k, d_walk, gid, n_gauss))
    e_rows, share, within, e_gauss, share_g, within_g, ok = compare_k3(
        torch, d_k, d_p, gid, n_gauss)
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
    k3 = dict(max_abs_err=float(max(e_walk.max(), e_rows.max())), ms=k3_ms,
              plain_ms=k3_plain_ms, **bound(t_bytes, walk, K3_CONTRIB_OPS),
              library_ms=None)
    print(f"[{label}] pairs={n_pairs} in {n_tiles} {th}x{tw} tiles: "
          f"{depth_stats(torch, counts)} | vs the plain K3 from each tile's "
          f"start: max abs err per row "
          f"{[float(f'{e:.3g}') for e in e_walk.tolist()]} | pairs beyond "
          f"{GRAD_ATOL} + {GRAD_RTOL} max|row|: {share_w:.3g} (within flip "
          f"allowance: {within_w}) | per gaussian max err "
          f"{float(e_gauss_w.max()):.3g}, beyond: {share_gw:.3g} (within: "
          f"{within_gw}) | vs the plain K3 from K2's state: max abs err per "
          f"row {[float(f'{e:.3g}') for e in e_rows.tolist()]} | pairs "
          f"beyond {share:.3g} (within: {within}) | per gaussian max err "
          f"{float(e_gauss.max()):.3g}, beyond: {share_g:.3g} (within: "
          f"{within_g}) | rows 10-15 zero, repeats bit for bit | walked, "
          f"kept, contributing share of pair-pixels "
          f"{walk_shares(walk, n_pairs * pix)} | kernel {k3_ms:.4f} ms, "
          f"plain {k3_plain_ms:.2f} ms, bound {k3['bound_ms']:.4f} ms "
          f"({k3['bound_by']}) | {card}", flush=True)
    if not (ok_w and ok):
        fail(f"K3 disagrees with its plain version at {label}")
    return k3


def k3_fault(torch, card, label, k3_args, gid, n_gauss):
    """A planted fault that the K3 bar must catch: K3 fed, for the first
    item of the deepest tile, the state of the item after it, held by
    ``compare_k3`` against the plain K3 walking each tile from its start
    and against the plain K3 on the true state. Fails if the bar passes
    it against either."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (composite,
                                                            composite_cuda)

    *args, state = k3_args
    counts = args[2]
    deep = int(torch.argmax(counts))
    first = int(composite.item_ends(counts)[deep]) - (
        -(-int(counts[deep]) // composite.ITEM_PAIRS))
    if counts[deep] <= composite.ITEM_PAIRS:
        fail(f"{label}: the deepest tile has one item, no fault to plant")
    bad = state.clone()
    bad[first] = state[first + 1]
    with torch.no_grad():
        d_k = composite_cuda.composite_bwd(*args, bad)
        refs = (("the plain K3 from each tile's start",
                 composite.composite_segments_bwd(*args)),
                ("the plain K3 from the true state",
                 composite.composite_segments_bwd(*k3_args)))
    passed = []
    for what, d_p in refs:
        e_rows, share, within, e_gauss, share_g, within_g, ok = compare_k3(
            torch, d_k, d_p, gid, n_gauss)
        print(f"[{label}] K3 fed the next item's state for item {first} "
              f"(tile {deep}, {int(counts[deep])} pairs) vs {what}: max abs "
              f"err per row {[float(f'{e:.3g}') for e in e_rows.tolist()]} "
              f"| pairs beyond the bar {share:.3g} (within flip allowance: "
              f"{within}), gaussians beyond {share_g:.3g} (within: "
              f"{within_g}) | the K3 bar "
              f"{'PASSES it' if ok else 'fails it, as it must'} | {card}",
              flush=True)
        if ok:
            passed.append(what)
    if passed:
        fail(f"the K3 bar does not catch the next-item state at {label} "
             f"against {passed}")


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
    from multiview_inpaint_tpu_torch import kernels as _kernels
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
                    "composite_bwd": 0, "flash_attn_fwd": 0,
                    "flash_attn_bwd": 0}:
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
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.gs.scene import Scene
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera
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
    k2_with_state(torch, card, probe.k3_args)
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


def k2_with_state(torch, card, k3_args):
    """K2 on K3's inputs (main path 2's first step) with and without
    the per-item state: tiles bit-equal, the state held against the plain
    K2's (``compare_state``), and both timed."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (composite,
                                                            composite_cuda)

    attrs, seg_start, counts, tiles8, _, *size, state = k3_args
    n_items = int(composite.item_ends(counts)[-1])  # rows past it are unset
    k2_args = (attrs.detach(), seg_start, counts, *size)
    with torch.no_grad():
        plain = composite_cuda.composite_fwd(*k2_args)
        with_st, st = composite_cuda.composite_fwd(*k2_args, with_state=True)
        ms = cuda_ms(torch, lambda: composite_cuda.composite_fwd(*k2_args),
                     10)
        ms_st = cuda_ms(torch, lambda: composite_cuda.composite_fwd(
            *k2_args, with_state=True), 10)
        _, st_p = composite.composite_segments(*k2_args, with_state=True)
    note = compare_state(torch, "10 K2 orbit-train", attrs, counts, st, st_p)
    same = (torch.equal(plain, with_st) and torch.equal(plain, tiles8)
            and torch.equal(st[:n_items], state[:n_items]))
    print(f"[10 K2 orbit-train] tiles equal with and without the per-item "
          f"state ({tuple(st.shape)}, {st.numel() * 4 / 1e6:.1f} MB) and "
          f"equal to the step's, state equal to the step's: {same} | "
          f"{note} | kernel {ms:.4f} ms, with the state {ms_st:.4f} ms | "
          f"{card}",
          flush=True)
    if not same:
        fail("K2's tiles or state differ with the state output at "
             "orbit-train")


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
    k3_fault(torch, card, "11 K3 planted fault", probe.k3_args, probe.gid,
             state.params.capacity)


def phase_k4(torch, card):
    """K4 against its plain version on packed [B, T, H*D] inputs at the
    main path's shapes; returns the record of the ds1 shape for the
    kernels line (launches filled in later). The launches made here are
    taken off the counters again."""
    import torch.nn.functional as F

    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import flash_attention as fa

    records = []
    saved = dict(_kernels.LAUNCHES)
    for b, t, h, d, dtype in K4_SHAPES:
        gen = torch.Generator(device=DEVICE).manual_seed(b * h + t)
        q, k, v = (torch.randn((b, t, h * d), generator=gen, device=DEVICE)
                   .to(getattr(torch, dtype)) for _ in range(3))
        scale = d ** -0.5
        with torch.no_grad():
            out = fa.flash_attention(q, k, v, h, scale)
            again = fa.flash_attention(q, k, v, h, scale)
            folded = fa.flash_mha(fa._fold(q, h), fa._fold(k, h),
                                  fa._fold(v, h), scale)
            plain = fa.flash_attention_ref(q, k, v, h, scale)
            err = float((out.float() - plain.float()).abs().max())
            rel = err / float(plain.float().abs().max())
            equal = torch.equal(out, again)
            same_folded = torch.equal(fa._unfold(folded, h), out)
            ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, h, scale),
                         20)
            plain_ms = cuda_ms(
                torch, lambda: fa.flash_attention_ref(q, k, v, h, scale), 3)
            qh, kh, vh = (x.view(b, t, h, d).transpose(1, 2)
                          for x in (q, k, v))
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, scale=scale), 20)
        flop = 4 * b * h * t * t * d
        t_ops = max(flop / BF16_FLOP_PER_S, b * h * t * t / SFU_OP_PER_S)
        t_bytes = 4 * q.numel() * q.element_size() / HBM_BYTES_PER_S
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   library_ms=lib_ms, vs_library=ms / lib_ms)
        records.append(rec)
        print(f"[12 K4 {dtype} [{b}, {t}, {h}*{d}], {h} heads] max abs err "
              f"{err:.4g} (bar {K4_ABS_TOL}), rel {rel:.4g} (bar "
              f"{K4_REL_TOL}) | bit-equal on a second run: {equal}, equal "
              f"to K4 on the folded [{b * h}, {t}, {d}]: {same_folded} | "
              f"kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}, {rec['bound_ms'] / ms:.3f} of it), SDPA "
              f"{lib_ms:.4f} ms (yardstick only), kernel/SDPA "
              f"{ms / lib_ms:.3f}x | {card}", flush=True)
        if not (torch.isfinite(out).all() and equal and same_folded
                and err <= K4_ABS_TOL and rel <= K4_REL_TOL):
            fail(f"K4 disagrees with its plain version at [{b}, {t}, "
                 f"{h}*{d}] {dtype}")
    _kernels.LAUNCHES.update(saved)
    return records[0]


def _tiny_svd_config():
    import argparse

    from multiview_inpaint_tpu_torch.pipelines import svd_test
    return svd_test._engine_config(argparse.Namespace(
        tiny_model=True, num_frames=3, num_steps=2))


def perturb_zero_params(torch, module, seed, std=0.02):
    """Move every all-zero parameter (the zero-initialised output convs
    and projections, zero convs, mix factors, biases) to seeded N(0,
    std^2) values, so that a mis-wired block or a wrong kernel shows in
    the output; returns how many tensors moved."""
    gen = torch.Generator(device=next(module.parameters()).device
                          ).manual_seed(seed)
    moved = 0
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(std * torch.randn(p.shape, generator=gen,
                                          device=p.device))
                moved += 1
    return moved


def _svd_batch(torch, frames, h, w, dev, seed):
    rng = np.random.default_rng(seed)
    frame = rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
    batch = {"cond_frames_without_noise": frame, "cond_frames": frame,
             "fps_id": np.array([6.0], np.float32),
             "motion_bucket_id": np.array([127.0], np.float32),
             "cond_aug": np.array([0.0], np.float32),
             "control_hint": rng.uniform(0, 1, (frames, h, w, 7)).astype(
                 np.float32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def f32_spacing(torch, x):
    """The spacing of f32 numbers at each entry of the f32 tensor ``x``."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 24)


def phase_svd_engine(torch):
    """The tiny SVD engine on DEVICE against the CPU, same weights (every
    all-zero parameter moved), same injected noise, f32 with TF32 off:
    conditioning, one guided denoiser evaluation, a 2-step sample, and
    the CPU's latents decoded on both."""
    from multiview_inpaint_tpu_torch.diffusion import engine, samplers

    cfg = _tiny_svd_config()
    cpu = engine.init_engine(cfg, seed=0, device="cpu")
    moved = perturb_zero_params(torch, cpu, 1)
    gpu = engine.init_engine(cfg, seed=1, device=DEVICE)
    gpu.load_reference_state_dict(cpu.reference_state_dict())
    noise = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 8, 6, 4)).astype(np.float32))
    sig = torch.full((6,), cfg.sigma_max)
    outs = []
    for eng, dev in ((cpu, "cpu"), (gpu, DEVICE)):
        b = _svd_batch(torch, 3, 64, 48, dev, 2)
        c = eng.prepare_cond(b)
        uc = eng.prepare_cond(b, unconditional=True)
        uc["control_hint"] = c["control_hint"]
        gx, gs, gc = eng.guider.prepare(noise.to(dev) * cfg.sigma_max,
                                        sig[:3].to(dev), c, uc)
        den = eng.denoise_fn()(gx, gs, gc)
        z = eng.sample(c, uc, noise=noise)
        z_cpu = z if dev == "cpu" else outs[0]["latents"].to(dev)
        outs.append(dict(c, denoiser=den, latents=z,
                         frames=eng.decode_first_stage(z_cpu, 3)))
    a, b = outs
    z_cpu = a.pop("latents")
    dz = (b.pop("latents").cpu() - z_cpu).abs()
    rel = {k: float((b[k].cpu() - a[k]).abs().max())
           / max(float(a[k].abs().max()), 1e-6) for k in a}
    spacing = f32_spacing(torch, samplers.prepare_x(
        noise, torch.tensor([cfg.sigma_max])).abs())
    z_bar = (SVD_F32_REL_TOL * float(z_cpu.abs().max())
             + SVD_X0_ULPS * spacing)
    print(f"[13 svd engine] tiny engine {DEVICE} vs cpu (f32, TF32 off, "
          f"{moved} all-zero parameters moved): max abs err / max|cpu| "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in rel.items()})} "
          f"(bar {SVD_F32_REL_TOL}; frames decode the cpu's latents on "
          f"both) | 2-step latents: max abs err {float(dz.max()):.4g}, "
          f"{float((dz / spacing).max()):.3g} f32 spacings at the entry's "
          f"|x0| at most, {float((dz / z_bar).max()):.3g} of the bar "
          f"({SVD_F32_REL_TOL} of max|latents| + {SVD_X0_ULPS} spacings)",
          flush=True)
    if any(v > SVD_F32_REL_TOL for v in rel.values()) or (dz > z_bar).any():
        fail(f"the SVD engine on {DEVICE} disagrees with the cpu")


class SvdProbe:
    """CUDA events around what ``svd_test.run`` calls on its engine:
    ``prepare_cond`` (conditioning: CLIP + VAE encode), each denoiser
    evaluation of ``sample`` (one per sampler step) and
    ``decode_first_stage``; keeps the engine and the sampler's
    conditioning. ``attach`` wraps the engine instance's methods."""

    def __init__(self, torch):
        self.torch, self.engine, self.conds = torch, None, None
        self.ev = {"cond": [], "step": [], "sample_end": [], "decode": []}
        self.peak_gb = {}

    def event(self, key):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        self.ev[key].append(e)

    def attach(self, eng):
        self.engine = eng
        prepare, sample = eng.prepare_cond, eng.sample
        decode, denoise_fn = eng.decode_first_stage, eng.denoise_fn

        def peak(key, fn, *a, **kw):
            """fn's result; the peak of allocated device memory while it
            ran, per key."""
            self.torch.cuda.reset_peak_memory_stats()
            out = fn(*a, **kw)
            self.peak_gb[key] = max(self.peak_gb.get(key, 0.0),
                                    self.torch.cuda.max_memory_allocated()
                                    / 1e9)
            return out

        def timed(fn, key):
            def run(*a, **kw):
                self.event(key)
                out = peak(key, fn, *a, **kw)
                self.event(key)
                return out
            return run

        def probed_sample(cond, uc, **kw):
            self.conds = (cond, uc)
            out = peak("sample", sample, cond, uc, **kw)
            self.event("sample_end")
            return out

        def probed_denoise_fn():
            dn = denoise_fn()

            def run(*a):
                self.event("step")
                return dn(*a)
            return run

        eng.prepare_cond = timed(prepare, "cond")
        eng.decode_first_stage = timed(decode, "decode")
        eng.sample = probed_sample
        eng.denoise_fn = probed_denoise_fn

    def split(self):
        """(conditioning ms, per-step ms list, decode ms)."""
        def pairs(evs):
            return [a.elapsed_time(b) for a, b in zip(evs[::2], evs[1::2])]
        marks = self.ev["step"] + self.ev["sample_end"]
        steps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return sum(pairs(self.ev["cond"])), steps, sum(pairs(
            self.ev["decode"]))


def phase_svd_main(torch, card):
    """Main path 3: the svd_test CLI at full width on a synthetic gs/ tree
    (1 scene, 1 ctrl, mode x1), every all-zero parameter of the random
    engine moved and the counters zeroed before; returns the launch counts
    and the probe (its engine and conditioning)."""
    from PIL import Image

    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.pipelines import svd_test
    from multiview_inpaint_tpu_torch.utils import synthetic

    work = os.path.join(REPO, "build", "smoke_svd")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "gs")
    synthetic.write_gs_tree(root, scene="scene_case", ctrl="ctrl_0",
                            modes=("x1",), frames=SVD_FRAMES,
                            size=(SVD_H, SVD_W), iteration=30000)
    probe = SvdProbe(torch)
    init_engine = svd_test.init_engine
    info = {}

    def init(*a, **kw):
        t0 = time.perf_counter()
        eng = init_engine(*a, **kw)
        info["moved"] = perturb_zero_params(torch, eng, 7)
        torch.cuda.synchronize()
        info["init_s"] = time.perf_counter() - t0
        info["params"] = sum(p.numel() for p in eng.parameters())
        probe.attach(eng)
        return eng

    svd_test.init_engine = init
    try:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        svd_test.main(["--data_root", root, "--logdir",
                       os.path.join(work, "logs"), "--modes", "x1",
                       "--num_frames", str(SVD_FRAMES), "--num_steps",
                       str(SVD_STEPS), "--size", str(SVD_H), str(SVD_W),
                       "--device", DEVICE])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        svd_test.init_engine = init_engine
    launches = dict(_kernels.LAUNCHES)
    cond_ms, steps, decode_ms = probe.split()
    out_dir = os.path.join(root, "inpainted", "scene_case", "ctrl_0", "x1")
    pngs = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    finite = []
    for p in pngs:
        with Image.open(os.path.join(out_dir, p)) as im:
            arr = np.asarray(im, np.float32)
        finite.append(arr.shape == (SVD_H, SVD_W, 3)
                      and bool(np.isfinite(arr).all()))
    clip_s = (cond_ms + sum(steps) + decode_ms) / 1e3
    want = K4_PER_EVAL * SVD_STEPS
    checks = {
        f"{SVD_FRAMES} frames written": len(pngs) == SVD_FRAMES,
        f"frames finite, {SVD_H}x{SVD_W}": bool(finite) and all(finite),
        f"K4 launched {want} times": launches["flash_attn_fwd"] == want,
        "no rasterizer kernel": launches["composite"] == 0,
        f"{SVD_STEPS} denoiser evaluations": len(steps) == SVD_STEPS,
    }
    print(f"[14 main svd] svd_test CLI, {info.get('params')} parameters "
          f"(bf16; the VAE f32) initialised on the card in "
          f"{info.get('init_s', 0):.1f} s ({info.get('moved')} all-zero "
          f"tensors moved), {SVD_FRAMES} frames at {SVD_H}x{SVD_W}, "
          f"{SVD_STEPS} steps, CFG batch {2 * SVD_FRAMES}, in {cli_s:.1f} s | "
          f"clip {clip_s:.2f} s: conditioning (CLIP + VAE encode, c and uc) "
          f"{cond_ms:.1f} ms, sampler step median "
          f"{statistics.median(steps) if steps else 0:.1f} ms (all "
          f"{[round(s, 1) for s in steps]}), VAE decode {decode_ms:.1f} ms "
          f"| peak device memory (GB) while each part ran "
          f"{json.dumps({k: round(v, 2) for k, v in probe.peak_gb.items()})} "
          f"| launches {launches} | "
          f"{json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 3 (svd_test CLI) checks failed: {checks}")
    return launches, probe


def phase_svd_eval(torch, card, probe):
    """One full-width guided denoiser evaluation at sigma_max, q and k
    projections scaled by SVD_QK_GAIN: through K4; with ``attention_op``'s
    K4 call patched to the plain version; patched to two planted faults
    (the plain version without the first 64-key tile, and K4 with the
    scale that an exp2 softmax without log2(e) would give); through K4
    from another noise seed."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import (attention_op,
                                                       flash_attention)
    from multiview_inpaint_tpu_torch.diffusion.transformer import (
        CrossAttention)

    eng = probe.engine
    cond, uc = probe.conds
    shape = (SVD_FRAMES, SVD_H // 8, SVD_W // 8, 4)
    sigma = torch.full((SVD_FRAMES,), eng.cfg.sigma_max, device=DEVICE)
    with torch.no_grad():
        for m in eng.modules():
            if isinstance(m, CrossAttention):
                m.to_q.weight.mul_(SVD_QK_GAIN)
                m.to_k.weight.mul_(SVD_QK_GAIN)
    real = attention_op.flash_attention
    ref = flash_attention.flash_attention_ref
    logit_std = []

    def k4_logged(q, k, v, heads, sm):
        """K4; notes the std of one ds1 head's logits on 256 rows."""
        if not logit_std and q.shape[1] == 3072:
            d = q.shape[2] // heads
            s = q[0, :256, :d].float() @ k[0, :, :d].float().T * sm
            logit_std.append(float(s.std()))
        return real(q, k, v, heads, sm)

    def evaluate(seed, attend):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        x = torch.randn(shape, generator=gen, device=DEVICE) * float(
            (1 + eng.cfg.sigma_max ** 2) ** 0.5)
        attention_op.flash_attention = attend
        try:
            _kernels.reset_launches()
            gx, gs, gc = eng.guider.prepare(x, sigma, cond, uc)
            out = eng.denoise_fn()(gx, gs, gc)
            torch.cuda.synchronize()
        finally:
            attention_op.flash_attention = real
        return out, _kernels.LAUNCHES["flash_attn_fwd"]

    out_k4, n_k4 = evaluate(11, k4_logged)
    out_plain, n_plain = evaluate(11, ref)
    out_drop, _ = evaluate(11, lambda q, k, v, h, sm: ref(
        q, k[:, FAULT_KEYS:], v[:, FAULT_KEYS:], h, sm))
    out_base, _ = evaluate(11, lambda q, k, v, h, sm: real(
        q, k, v, h, sm * math.log(2)))
    out_seed, _ = evaluate(12, real)
    scale = float(out_plain.abs().max())

    def diff(a, b):
        return float((a - b).abs().max())

    def rms(a, b):
        return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())

    err, drop, base = (rms(o, out_plain) for o in (out_k4, out_drop,
                                                   out_base))
    seed_diff = rms(out_seed, out_k4)
    bar = SVD_EVAL_RMS_TOL
    print(f"[15 svd eval] one guided denoiser evaluation at sigma "
          f"{eng.cfg.sigma_max} (batch {2 * SVD_FRAMES}), q and k x"
          f"{SVD_QK_GAIN} (logit std of a ds1 head {logit_std}): K4 "
          f"launches {n_k4}, with attention_op's K4 call patched to the "
          f"plain version {n_plain} | relative rms diff from the "
          f"plain-attention output: K4 {err:.4g} (max abs "
          f"{diff(out_k4, out_plain):.4g} of max|plain| {scale:.4g}), bar "
          f"{bar}; planted faults: first key tile dropped {drop:.4g} (max "
          f"abs {diff(out_drop, out_plain):.4g}), softmax base 2 "
          f"{base:.4g} (max abs {diff(out_base, out_plain):.4g}) | another "
          f"noise seed moves it by {seed_diff:.4g} (max abs "
          f"{diff(out_seed, out_k4):.4g}; bar at most a tenth: "
          f"{bar <= seed_diff / 10}) | all finite: "
          f"{bool(torch.isfinite(out_k4).all())} | {card}", flush=True)
    if not (n_k4 == K4_PER_EVAL and n_plain == 0 and err <= bar
            and bar < min(drop, base) and bar <= seed_diff / 10
            and torch.isfinite(out_k4).all()):
        fail("the full-width denoiser through K4 disagrees with the plain "
             "attention, or the bar does not separate the planted faults")


def _rms(a, b):
    """Relative rms of a - b against b (f32)."""
    a, b = a.float(), b.float()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def phase_k5(torch, card):
    """K5 against its plain version on packed [B, T, H*D] inputs at main
    path 4's shapes, o and the logsumexp from K4, a seeded cotangent;
    returns the record of the ds1 shape for the kernels line (launches
    filled in later). The launches made here are taken off the counters
    again."""
    import torch.nn.functional as F

    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import flash_attention as fa

    records = []
    saved = dict(_kernels.LAUNCHES)
    for b, t, h, d, dtype in K5_SHAPES:
        gen = torch.Generator(device=DEVICE).manual_seed(b * h + t + 5)
        q, k, v, do = (torch.randn((b, t, h * d), generator=gen,
                                   device=DEVICE).to(getattr(torch, dtype))
                       for _ in range(4))
        scale = d ** -0.5
        with torch.no_grad():
            o, lse = fa._launch(q, k, v, h, scale, True)
            args = (q, k, v, o, lse, do, h, scale)
            got = fa.flash_attention_bwd(*args)
            again = fa.flash_attention_bwd(*args)
            plain = fa.flash_attention_bwd_ref(*args)
            rel = max(float((g.float() - p.float()).abs().max())
                      / float(p.float().abs().max())
                      for g, p in zip(got, plain))
            rms = max(_rms(g, p) for g, p in zip(got, plain))
            err = max(float((g.float() - p.float()).abs().max())
                      for g, p in zip(got, plain))
            equal = all(torch.equal(x, y) for x, y in zip(got, again))
            finite = all(bool(torch.isfinite(x).all()) for x in got)
            ms = cuda_ms(torch, lambda: fa.flash_attention_bwd(*args), 10)
            plain_ms = cuda_ms(
                torch, lambda: fa.flash_attention_bwd_ref(*args), 2)
        qh, kh, vh = (x.view(b, t, h, d).transpose(1, 2).detach()
                      .requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        doh = do.view(b, t, h, d).transpose(1, 2)
        lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            out, (qh, kh, vh), doh, retain_graph=True), 10)
        del out
        flop = 10 * b * h * t * t * d
        t_ops = max(flop / BF16_FLOP_PER_S, b * h * t * t / SFU_OP_PER_S)
        t_bytes = (7 * q.numel() * q.element_size()
                   + 2 * lse.numel() * 4) / HBM_BYTES_PER_S
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   library_ms=lib_ms, vs_library=ms / lib_ms)
        records.append(rec)
        print(f"[16 K5 {dtype} [{b}, {t}, {h}*{d}], {h} heads] dq/dk/dv max "
              f"abs err {err:.4g}, / max|plain| {rel:.4g} (bar "
              f"{K5_REL_TOL}), relative rms {rms:.4g} (bar {K5_RMS_TOL}) | "
              f"bit-equal on a second run: {equal}, finite: {finite} | "
              f"kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}, {rec['bound_ms'] / ms:.3f} of it), SDPA "
              f"backward {lib_ms:.4f} ms (yardstick only), kernel/SDPA "
              f"{ms / lib_ms:.3f}x | {card}", flush=True)
        if not (finite and equal and rel <= K5_REL_TOL
                and rms <= K5_RMS_TOL):
            fail(f"K5 disagrees with its plain version at [{b}, {t}, "
                 f"{h}*{d}] {dtype}")
    _kernels.LAUNCHES.update(saved)
    return records[0]


def _plain_bwd(torch, q, k, v, o, lse, do, heads, scale, fault=None):
    """Plain K5 on packed tensors (``flash_attention_bwd_ref``), or one of
    two planted faults: "delta" (delta = 0) or "tile" (the first 64 keys'
    contribution dropped from dq, dk and dv)."""
    from multiview_inpaint_tpu_torch.diffusion import flash_attention as fa
    if fault is None:
        return fa.flash_attention_bwd_ref(q, k, v, o, lse, do, heads, scale)
    if fault == "delta":
        return fa.flash_attention_bwd_ref(q, k, v, torch.zeros_like(o), lse,
                                          do, heads, scale)
    n0 = FAULT_KEYS
    qf, kf, vf, of_, dof = (fa._fold(x, heads) for x in (q, k, v, o, do))
    dt = q.dtype
    delta = (dof.float() * of_.float()).sum(-1)
    dof = dof.to(dt).float()
    s = torch.einsum("bqd,bkd->bqk", qf.float(), kf.float()) * scale
    p = torch.exp(s - lse[..., None])
    p[:, :, :n0] = 0
    dv = torch.einsum("bqk,bqd->bkd", p.to(dt).float(), dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf.float())
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dk = torch.einsum("bqk,bqd->bkd", ds, qf.float())
    dq = torch.einsum("bqk,bkd->bqd", ds, kf.float())
    return tuple(fa._unfold(g.to(dt), heads) for g in (dq, dk, dv))


def phase_k5_grad(torch, card):
    """The gradients of one full-width ds1 SpatialVideoTransformer (to_q,
    to_k x SVD_QK_GAIN, every all-zero parameter moved) through K4 + K5,
    against the same block with ``flash_attention.FlashAttention`` (the
    differentiable flash call) patched to the plain forward and backward
    and to two planted K5 faults."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import flash_attention
    from multiview_inpaint_tpu_torch.diffusion.transformer import (
        SpatialVideoTransformer)

    bf = torch.bfloat16
    torch.manual_seed(17)
    block = SpatialVideoTransformer(320, 5, 64, context_dim=1024,
                                    device=DEVICE, dtype=bf)
    moved = perturb_zero_params(torch, block, 18)
    with torch.no_grad():
        for blk in block.transformer_blocks:
            for lin in (blk.attn1.to_q, blk.attn1.to_k):
                lin.weight.mul_(SVD_QK_GAIN)
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    x = torch.randn((SVD_FRAMES, 320, SVD_H // 8, SVD_W // 8),
                    generator=gen, device=DEVICE).to(bf)
    ctx = torch.randn((SVD_FRAMES, 1, 1024), generator=gen,
                      device=DEVICE).to(bf)
    cot = torch.randn(x.shape, generator=gen, device=DEVICE)
    ind = torch.zeros((1, SVD_FRAMES), device=DEVICE)
    params = [p for p in block.parameters()]
    real = flash_attention.FlashAttention

    class Plain(torch.autograd.Function):
        """Plain K4 forward, plain K5 (or a fault) backward."""
        fault = None

        @staticmethod
        def forward(ctx_, q, k, v, heads, scale):
            out = flash_attention.flash_attention_ref(q, k, v, heads, scale)
            lse = flash_attention.lse_ref(flash_attention._fold(q, heads),
                                          flash_attention._fold(k, heads),
                                          scale)
            ctx_.save_for_backward(q, k, v, out, lse)
            ctx_.heads, ctx_.scale = heads, scale
            return out

        @staticmethod
        def backward(ctx_, do):
            q, k, v, out, lse = ctx_.saved_tensors
            return (*_plain_bwd(torch, q, k, v, out, lse, do.contiguous(),
                                ctx_.heads, ctx_.scale, Plain.fault),
                    None, None)

    def grads(fn, fault=None):
        Plain.fault = fault
        flash_attention.FlashAttention = fn
        try:
            _kernels.reset_launches()
            xi = x.detach().requires_grad_()
            out = block(xi, ctx, SVD_FRAMES, ind)
            g = torch.autograd.grad((out.float() * cot).sum(),
                                    [xi] + params)
            torch.cuda.synchronize()
        finally:
            flash_attention.FlashAttention = real
        counts = (_kernels.LAUNCHES["flash_attn_fwd"],
                  _kernels.LAUNCHES["flash_attn_bwd"])
        return torch.cat([t.float().reshape(-1) for t in g]), g[0], counts

    g_k, gx_k, n_k = grads(real)
    g_p, gx_p, n_p = grads(Plain)
    g_d, _, _ = grads(Plain, "delta")
    g_t, _, _ = grads(Plain, "tile")
    err, delta_rms, tile_rms = (_rms(g, g_p) for g in (g_k, g_d, g_t))
    err_x = _rms(gx_k, gx_p)
    bar = K5_GRAD_RMS_TOL
    print(f"[17 K5 grad] ds1 SpatialVideoTransformer (320 ch, 5 heads, "
          f"{SVD_FRAMES} frames at {SVD_H // 8}x{SVD_W // 8}, bf16, "
          f"{moved} all-zero tensors moved, q and k x{SVD_QK_GAIN}): "
          f"K4/K5 launches {n_k}, patched to the plain path {n_p} | "
          f"relative rms of all {g_p.numel()} gradient entries vs plain: "
          f"K4+K5 {err:.4g} (input gradient alone {err_x:.4g}), bar {bar}; "
          f"planted K5 faults: no delta {delta_rms:.4g}, first key tile "
          f"dropped {tile_rms:.4g} | finite: "
          f"{bool(torch.isfinite(g_k).all())} | {card}", flush=True)
    if not (n_k == (1, 1) and n_p == (0, 0) and err <= bar
            and bar < min(delta_rms, tile_rms)
            and torch.isfinite(g_k).all()):
        fail("the full-width transformer gradient through K4 + K5 "
             "disagrees with the plain path, or the bar does not separate "
             "the planted faults")


def phase_svd_train_step(torch):
    """One train step of the tiny SVD engine on DEVICE against the CPU:
    same weights (every all-zero parameter moved), data, sigma and noise,
    f32 with TF32 off. Bars: the loss at SVD_F32_REL_TOL relative, every
    ControlNet gradient within SVD_F32_REL_TOL of its max|g| + 1e-7, and
    the parameters after one Adam step within lr * 1e-3 where |g| >= 1e-6
    (well above eps: the step is g / (|g| + eps), sign-like); entries
    below are counted."""
    import argparse

    from multiview_inpaint_tpu_torch.diffusion import engine
    from multiview_inpaint_tpu_torch.parallel import svd_data_parallel as dp
    from multiview_inpaint_tpu_torch.pipelines import svd_train

    cfg = svd_train._engine_config(argparse.Namespace(
        tiny_model=True, num_frames=3, pose_cond=False, warp_loss=False))
    cpu = engine.init_engine(cfg, seed=0, device="cpu")
    perturb_zero_params(torch, cpu, 21)
    gpu = engine.init_engine(cfg, seed=1, device=DEVICE)
    gpu.load_reference_state_dict(cpu.reference_state_dict())
    rng = np.random.default_rng(22)
    lat = rng.normal(size=(1, 3, 8, 6, 4)).astype(np.float32)
    noise = rng.normal(size=lat.shape).astype(np.float32)
    sig = np.array([1.7], np.float32)
    lr = 1e-4
    out = []
    for eng, dev in ((cpu, "cpu"), (gpu, DEVICE)):
        b = _svd_batch(torch, 3, 64, 48, dev, 23)
        c = eng.prepare_cond(b)
        cond_b = {k: v[None] for k, v in c.items()}
        params = dp.trainable_params(eng)
        opt = dp.build_optimizer(lr)
        state = opt.init(params)
        before = {k: p.detach().clone() for k, p in params.items()}
        lat_t = torch.from_numpy(lat).to(dev)
        lat_f, cond, _ = dp.flatten_videos(lat_t, cond_b)
        loss = eng.loss(lat_f, cond, sigmas=torch.from_numpy(sig).to(dev),
                        noise=torch.from_numpy(noise).to(dev).reshape(
                            lat_f.shape))
        g = torch.autograd.grad(loss, list(params.values()))
        opt.step(params, dict(zip(params, g)), state)
        out.append((float(loss.detach()),
                    {k: x.cpu() for k, x in zip(params, g)},
                    {k: p.detach().cpu() for k, p in params.items()},
                    before))
    (l0, g0, p0, _), (l1, g1, p1, _) = out
    gmax = max(float(x.abs().max()) for x in g0.values())
    g_bad = sum(int(((g1[k] - g0[k]).abs()
                     > SVD_F32_REL_TOL * float(g0[k].abs().max()) + 1e-7)
                    .sum()) for k in g0)
    big = {k: g0[k].abs() >= 1e-6 for k in g0}
    p_err = max(float((p1[k] - p0[k]).abs()[big[k]].max())
                if big[k].any() else 0.0 for k in p0)
    small = sum(int((~big[k]).sum()) for k in big)
    total = sum(x.numel() for x in g0.values())
    loss_rel = abs(l1 - l0) / abs(l0)
    print(f"[18 svd train step] tiny engine train step {DEVICE} vs cpu (f32, "
          f"TF32 off): loss {l0:.6g} vs {l1:.6g} (rel {loss_rel:.3g}, bar "
          f"{SVD_F32_REL_TOL}) | ControlNet gradients: {g_bad} of {total} "
          f"entries beyond {SVD_F32_REL_TOL} of their tensor's max|g| + 1e-7 "
          f"(max|g| {gmax:.4g}) | params after one Adam step (lr {lr}): max "
          f"diff {p_err:.3g} where |g| >= 1e-6 (bar {lr * 1e-3}); {small} "
          f"entries below counted, not compared", flush=True)
    if loss_rel > SVD_F32_REL_TOL or g_bad or p_err > lr * 1e-3:
        fail(f"the tiny SVD train step on {DEVICE} disagrees with the cpu")


def _fingerprints(torch, module):
    """Per-tensor position-weighted sums of the raw bits: any change of a
    bit of a parameter changes its fingerprint."""
    out = {}
    with torch.no_grad():
        for k, p in module.state_dict().items():
            bits = p.contiguous().view(
                {2: torch.int16, 4: torch.int32}[p.element_size()]).reshape(
                -1).to(torch.int64)
            w = torch.arange(bits.numel(), device=p.device) % 65521 + 1
            out[k] = int((bits * w).sum())
    return out


def phase_svd_train(torch, card):
    """Main path 4: the svd_train CLI at full width, counters zeroed
    before; returns its launch counts."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import checkpoint as ckpt
    from multiview_inpaint_tpu_torch.pipelines import svd_train
    from multiview_inpaint_tpu_torch.utils import synthetic

    work = os.path.join(REPO, "build", "smoke_svd_train")
    shutil.rmtree(work, ignore_errors=True)
    root, logdir = os.path.join(work, "est"), os.path.join(work, "logs")
    t0 = time.perf_counter()
    synthetic.write_est_tree(root, scenes=TRAIN_SVD_SCENES,
                             frames=SVD_FRAMES, size=(SVD_H, SVD_W))
    tree_s = time.perf_counter() - t0
    info = {"step_s": [], "save_s": []}
    init_engine, make_step = svd_train.init_engine, svd_train.make_train_step
    save_params = ckpt.save_params

    def init(*a, **kw):
        t1 = time.perf_counter()
        eng = init_engine(*a, **kw)
        info["moved"] = perturb_zero_params(torch, eng, 27)
        torch.cuda.synchronize()
        info["init_s"] = time.perf_counter() - t1
        info["params"] = sum(p.numel() for p in eng.parameters())
        info["engine"] = eng
        info["frozen"] = {n: _fingerprints(torch, getattr(eng, n))
                          for n in ("unet", "vae", "clip")}
        info["cn0"] = {k: p.detach().clone()
                       for k, p in eng.controlnet.named_parameters()}
        return eng

    def make(eng, optimizer, params, ema_decay=None):
        step = make_step(eng, optimizer, params, ema_decay)

        def timed(*a, **kw):
            info["ema"] = a[1]
            before = ({k: p.detach().clone() for k, p in params.items()}
                      if not info["step_s"] else None)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = step(*a, **kw)
            torch.cuda.synchronize()
            info["step_s"].append(time.perf_counter() - t1)
            if before is not None:
                n = sum(p.numel() for p in params.values())
                info["changed_first"] = sum(
                    int((p.detach() != before[k]).sum())
                    for k, p in params.items()) / n
            return loss
        return timed

    def timed_save(*a, **kw):
        t1 = time.perf_counter()
        save_params(*a, **kw)
        info["save_s"].append(time.perf_counter() - t1)

    svd_train.init_engine, svd_train.make_train_step = init, make
    ckpt.save_params = timed_save
    try:
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        svd_train.main(["--data_root", root, "--logdir", logdir,
                        "--epochs", "1", "--num_frames", str(SVD_FRAMES),
                        "--size", str(SVD_H), str(SVD_W), "--ckpt_every",
                        "1", "--log_interval", "1", "--ema", "--device",
                        DEVICE])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        svd_train.init_engine, svd_train.make_train_step = init_engine, \
            make_step
        ckpt.save_params = save_params
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(_kernels.LAUNCHES)
    eng = info.pop("engine")
    steps = len(info["step_s"])
    with open(os.path.join(logdir, "svd_train_log.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    frozen_same = {n: _fingerprints(torch, getattr(eng, n))
                   == info["frozen"][n] for n in ("unet", "vae", "clip")}
    cn_moved = sum(int((p.detach() != info["cn0"][k]).sum())
                   for k, p in eng.controlnet.named_parameters())
    cn_total = sum(p.numel() for p in eng.controlnet.parameters())
    path = os.path.join(logdir, "checkpoints", "epoch=000000.npz")
    ema = info.get("ema", {})
    read_back = os.path.exists(path) and bool(ema)
    if read_back:   # the EMA, written as f32, reads back bit for bit
        loaded = ckpt.state_dict_from_jax(ckpt.load_params(path),
                                          "controlnet")
        read_back = set(loaded) == set(ema) and all(
            torch.equal(loaded[k].to(DEVICE, v.dtype), v)
            for k, v in ema.items())
    want_k5, want_k4 = K5_PER_STEP * steps, K4_PER_TRAIN_STEP * steps
    checks = {
        f"{TRAIN_SVD_SCENES} steps": steps == TRAIN_SVD_SCENES,
        f"K5 launched {want_k5} times": launches["flash_attn_bwd"] == want_k5,
        f"K4 launched {want_k4} times": launches["flash_attn_fwd"] == want_k4,
        "losses finite": len(losses) == steps and all(
            math.isfinite(x) for x in losses),
        "UNet, VAE, CLIP bit-unchanged": all(frozen_same.values()),
        "ControlNet moved": cn_moved > 0,
        "checkpoint written and read back": read_back,
    }
    step_ms = [round(x * 1e3, 1) for x in info["step_s"]]
    print(f"[19 main svd train] svd_train CLI, {info.get('params')} "
          f"parameters (bf16; the VAE f32; {info.get('moved')} all-zero "
          f"tensors moved) initialised in {info.get('init_s', 0):.1f} s, "
          f"{TRAIN_SVD_SCENES} scenes of {SVD_FRAMES} frames at {SVD_H}x"
          f"{SVD_W} written in {tree_s:.1f} s, 1 epoch at batch 1, --ema, "
          f"remat none, in {cli_s:.1f} s | step ms (host clock, "
          f"synchronised) {step_ms}, median after the first "
          f"{statistics.median(step_ms[1:]) if steps > 1 else 0} | losses "
          f"{[round(x, 4) for x in losses]} | peak device memory "
          f"{peak_gb:.2f} GB | checkpoint save s {info['save_s']} | "
          f"ControlNet entries changed by the first step "
          f"{info.get('changed_first', 0):.4f}, by the run "
          f"{cn_moved / cn_total:.4f} of {cn_total} | launches {launches} | "
          f"{json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 4 (svd_train CLI) checks failed: {checks}")
    return launches


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
    k4 = phase_k4(torch, card)
    phase_svd_engine(torch)
    launches_svd, probe = phase_svd_main(torch, card)
    phase_svd_eval(torch, card, probe)
    del probe   # main path 3's engine
    torch.cuda.empty_cache()
    k5 = phase_k5(torch, card)
    phase_k5_grad(torch, card)
    phase_svd_train_step(torch)
    launches_svd_train = phase_svd_train(torch, card)

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
        # K4 at the ds1 shape of main path 3, the path that runs it.
        dict(name="flash_attn_fwd", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/flash_attn_fwd.cu",
             replaces="multiview_inpaint_tpu/diffusion/"
                      "flash_attention.py:55",
             launches=launches_svd["flash_attn_fwd"], **k4),
        # K5 at the ds1 shape of main path 4, the path that runs it; one
        # launch is the dk/dv kernel and the dq kernel back to back.
        dict(name="flash_attn_bwd", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/flash_attn_bwd.cu",
             replaces="multiview_inpaint_tpu/diffusion/"
                      "flash_attention.py:117",
             launches=launches_svd_train["flash_attn_bwd"], **k5),
    ]
    print(f"[20 done] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
