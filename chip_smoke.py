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
   and K3's registers, spills and static shared memory (ptxas), K2's
   blocks per SM, and K3's blocks per SM and splats per warp reduction;
3. K1 (pair keys) against its plain version, bit for bit, on the 1080p
   bench frames of the 100k bench ball and the 2M-gaussian scene;
4. K2 (composite) against its plain version on the same frames: max
   errors, pixels beyond rgb 3e-5 / depth 3e-4 (at most 0.01%), every
   pixel within the stop-flip bound; its tiles bit-equal with and without
   the per-item state output, and that state against the plain K2's at
   the same bars over every item-pixel (``compare_state``); on the 2M
   frame, a planted fault (``k2_fault``: every gate box pulled in by one
   pixel) that the same bar must fail;
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
    gradient norms), K1 on its inputs (bit-equal keys) timed with its
    bound, and K2 on its inputs timed with and without the per-item
    state, with its bound (tiles and state bit-equal to the step's, the
    state against the plain K2's as in phase 4); then the
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
20. main path 5's workspace (stage 1): the bench COLMAP scene of phase 9,
    the 2M-gaussian PLY, a ``--registry`` JSON (front view view00, the
    bicycle scene's orbit and vis parameters), an insertion box at the
    front of the foreground clusters near the origin and a deletion box
    inside the scene;
21. main path 5: the ``gen_seq`` CLI (14 frames x modes x1, x2 at
    512x384 and the 4 ``bds_train`` views at 1920x1080), counters zeroed
    before: K1 and K2 launched exactly 32 times each and K3-K5 never, 14
    renders/mask/masked PNGs per mode at 512x384, ``poses.npy`` (14, 4,
    4), ``cam_center.npy`` at the box centre, 4 ``bds_train`` masks at
    1080p, each mode's masks non-empty in a frame and not all ones in all;
    then the CLI again under ``SeqProbe`` for its split (load, render,
    mask, PNG writing), device ms per orbit frame, mask ms per frame at
    512x384 and 1080p, and the OBB step's peak device memory;
22. the ``gen_seq`` mask of frame 0 of x1 and of the front view at 1080p
    (and of the front view with the foreground clusters alone, which has
    empty pixels) through K1/K2 against the plain K2's route on the card:
    equal counts of pixels at the 15.0 sentinel, masks that differ only
    where t lies between the two depths within K2's stop-flip bound, the
    box hit on CUDA against the CPU except on rays within 1e-6 of a
    triangle edge (counted), the share of the box the scene hides in the
    front view (in (0, 1)); a planted fault (K2's empty pixels at a final
    T of 1 - 2^-24) that the sentinel check must fail; then phases 3-5's
    checks and times of K1-K3 at frame 0 of x1 (512x384);
23. the ``render_depth`` CLI (28 frames) and the ``vis_render --src`` CLI
    (55 frames) on the same scene, counters zeroed before each: K1 and K2
    launched exactly 28 and 55 times, no constant PNG; seconds and ms per
    frame;
24. the ``delete`` CLI on the 2M-gaussian PLY with the deletion box: some
    rows removed, none left inside by ``contains``, ``contains`` on CUDA
    against the CPU except on rows within 1e-6 of a face (counted); the
    ``gen_pc`` CLI writes 10,000 points; seconds of each;
25. main path 6 (stage 2) on main path 5's workspace: stand-ins for the
    ``svd_test`` frames, big2m and a 20,000-splat object of one saturated
    colour inside the insertion box rendered together (K1/K2) at the 28
    orbit poses and written as ctrl 0's inpainted PNGs, with each frame's
    visible-object mask (the object's alpha > 0.5 where it lies nearer
    than big2m);
26. the ``seg_masks`` CLI with ``--auto --propagate`` on modes x1 and x2:
    IoU of every frame's mask against the visible-object mask, median
    above 0.6 (the JAX test's bar), the worst frame, the box mask's own
    IoU beside it, ms per frame;
27. ``seg_masks --ground`` at full width on mode x1: random ViT-H/14 and
    23-layer text towers (every all-zero parameter moved, q and k x3)
    written as a JAX-layout f32 npz, a merges file the script writes and
    a plain-text query; every grounded mask within the same frame's
    ``--auto`` mask; the 57 window scores of frame 0 against the same
    towers in float64 on the card at 4 windows (bar 5e-3 of the largest
    float64 score); ms per frame, the towers' load time, peak memory;
28. one stage-2 step of each kind on ``load_sd_ply``'s 1,909,232 rows: a
    512x384 seq view with the full loss and a 1080p training view with
    the background loss (a cotangent exactly 0 inside the box): K3
    against its plain version as in phase 5 (``check_k3``), K1 and K2
    against theirs with the per-item state (``k2_with_state``), all timed
    with their bounds, the pairs whose K3 rows are all zero, the step's
    split and peak memory; the 51 cameras per epoch; the densification
    threshold (a quantile of the seq step's screen-space gradients);
29. the ``inpaint_rec`` CLI, 400 steps with densification at steps 50,
    100 and 150, counters zeroed before and read after: K1, K2 and K3
    launched once per step, the inpainted views' loss falls (first vs
    last 20 of them), densify wrote rows, no non-finite gradient, the PLY
    written and loaded, the masked PSNR of the seq views inside the SAM
    masks above the initial state's by 1 dB; median step ms per view kind
    and peak memory;
30. main path 7 (slice 7) on main path 5's workspace: a random
    SD-2-inpainting-width UNet2D and 2D VAE (every all-zero parameter
    moved) written as a ``.ckpt`` and read into the SDS prior as
    ``sds_train`` builds it, text embeddings [2, 77, 1024] from the seed;
    then phase 12's checks and times of K4 at the UNet2D's CFG shapes,
    [2, 4096, 5*64] (ds1) and [2, 1024, 10*64] (ds2) in f32;
31. one CFG evaluation of that UNet2D (q and k x3, as phase 15) through
    K4 against the same UNet with the plain attention (10 K4 launches,
    relative rms of the eps at phase 15's bar), two planted K4 faults
    that must exceed the bar, and another input seed;
32. one SDS step at full width on a 1080p bds_train view of the del PLY +
    30,000 box samples after a warm-up step (``SdsProbe``): K3 against
    its plain version under the step's own cotangent (the background
    loss's plus the SDS gradient through the VAE encoder and the 1080p ->
    512^2 resize), K1 and K2 with the per-item state against theirs,
    K1-K3 once and K4 10 times and K5 never, the SDS image gradient
    finite and non-zero inside the mask, peak memory, and the step's
    device ms beside its parts run alone (``sds_split``: render forward,
    VAE encode forward and backward, CFG UNet, Adam; the rest is the
    render backward, the losses and resizes); the densification
    threshold (a quantile of this step's gradients);
33. the ``sds_train`` CLI with the ``.ckpt`` and the embeddings, 60 steps
    on the 4 bds_train views, densifying at step 50: K1-K3 once and K4 10
    times per step, K5 never, the background loss of the 20 steps before
    the densification below the first 20's and finite after it, no
    non-finite gradient, the PLY written and loaded, median step ms and
    peak memory;
34. ``gen_seq --sds`` on that PLY, ``gen_depth --dpt_ckpt`` with a random
    DPT-large (ms per frame, peak memory) and ``gen_depth`` rendering the
    disparity, counters zeroed before each (K1 and K2 28 times each); the
    written disparity against the plain K2 route's on every frame (all
    but 0.01% of pixels equal, none off by more than 1 level);
35. the ``ctrl_inpaint`` CLI at full width (``--context_dim 768``,
    ``--size 512``) from random SD-1.5-size UNet2D + VAE and ControlNet2D
    ``.ckpt`` files: 2 samples of 10 UniPC steps, then 1 of DPM++(2M):
    K4 14 times per evaluation and no other kernel, s per sample, peak
    memory, the PNGs not constant;
36. the ``kernels`` JSON line (K1 and K2 at main path 1's big2m frame, K3
    at main path 2's first step, K4 at main path 3's ds1 shape, K5 at main
    path 4's ds1 shape; K4 and K5 also carry ``vs_library``, kernel ms over
    SDPA ms; K1-K3 also carry ``main_path_6``: its launches and its
    orbit-rec times and bounds at both step shapes; K1-K4 carry
    ``main_path_7``: its launches over all its CLIs, K1-K3's times and
    bounds at the SDS step's view, K4's at the UNet2D's ds1 and ds2); the
    last line is the ``ok`` JSON object.

Build outputs and the scenes go under ``build/`` in the checkout.
"""

import ctypes
import dataclasses
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


# Main path 5 (stage 1) on the 2M-gaussian bench scene, scene id
# <STAGE1_SCENE>_<STAGE1_CASE>. Its --registry JSON names view00 (the bench
# camera, at z = -3 looking down +z) as the front view and gives the scene
# the bicycle scene's orbit and vis parameters (``config/registries.py``).
# The insertion box sits at the front of the foreground clusters near the
# origin, partly behind the nearest of them from the front view (phase 22
# prints the share hidden); the deletion box lies inside the scene.
# gen_seq renders SEQ_FRAMES per mode at orbit_cameras' new_size (height,
# width) plus the bench views; vis_render --src sweeps VIS_FRAMES - 1
# frames.
STAGE1_SCENE, STAGE1_CASE = "bench", "chair"
STAGE1_ORBIT = dict(k_lift=math.pi / 6, r_scale=0.7, k_bias=0.0,
                    view_range=math.pi / 3)
INSERT_CENTER, INSERT_HALF = (0.15, -0.05, -0.75), 0.15
DELETE_CENTER, DELETE_HALF = (0.0, 0.0, 0.0), 0.5
SEQ_MODES, SEQ_FRAMES, VIS_FRAMES = ("x1", "x2"), 14, 56
ORBIT_H, ORBIT_W = 512, 384


# Main path 6 (stage 2) on main path 5's workspace. Stand-ins for the
# svd_test frames (random weights would paint noise): big2m and an object
# of OBJECT_N splats inside the insertion box (make_gt_gaussians' kind, one
# saturated colour) rendered together at the 28 orbit poses. seg_masks
# --auto --propagate must reach the JAX test's median IoU bar against the
# object's visible mask; --ground runs the full-width towers (ViT-H/14,
# the 23-layer text tower; random, every all-zero parameter moved, q and k
# scaled by SVD_QK_GAIN so that the attention is far from uniform) on mode
# x1, and holds the 57 window scores of frame 0 against the same towers in
# float64 on the card at GROUND_WINDOWS (bar: GROUND_REL_TOL of the
# largest float64 score). inpaint_rec trains REC_ITERS steps from
# load_sd_ply's 1,879,232 + REC_SAMPLES rows, densifying at REC_DENSIFY
# steps the rows whose mean screen-space gradient reaches the
# REC_DENSIFY_QUANTILE quantile of its first step's (the reference's 2e-4
# never fires here; main path 2's 0.8 quantile would split a fifth of the
# trained background at each densification), and the
# masked PSNR of the seq views inside the SAM masks must rise by
# REC_PSNR_MARGIN dB over the initial state's.
OBJECT_N, OBJECT_SPREAD, OBJECT_SCALE = 20_000, 0.12, 0.006
OBJECT_RGB, OBJECT_OPACITY = (0.9, 0.15, 0.1), 0.95
SEG_IOU_BAR = 0.6
GROUND_QUERY = "a red chair"
GROUND_MERGES = ("r e", "re d</w>", "c h", "ch a", "cha i", "chai r</w>",
                 "a </w>")
GROUND_WINDOWS, GROUND_REL_TOL = (0, 14, 30, 56), 5e-3
REC_SAMPLES, REC_ITERS = 30_000, 400
REC_DENSIFY = (50, 160, 50)      # from, until, interval: steps 50, 100, 150
REC_DENSIFY_QUANTILE = 0.99
REC_PSNR_MARGIN = 1.0
REC_CAMERAS = 27 + 6 * len(YAWS)   # 27 seq views + 6 x 4 training views


# Main path 7 (slice 7) on main path 5's workspace after main path 6. The
# SDS prior is SD-2-inpainting's width (UNet2DConfig(), VAEConfig()) with
# random weights, every all-zero parameter moved, in f32 as sds_train runs
# it: the render of a 1080p bds_train view shrunk to SDS_SIZE^2 (latents
# SDS_LATENT^2), CFG batch 2, so K4 runs the UNet2D's ds1 and ds2
# self-attention at K4_2D_SHAPES (packed [B, T, H*D], f32 in), 2 + 3 times
# each per evaluation (the ControlNet2D's trunk adds 2 + 2 in
# ctrl_inpaint). sds_train runs SDS_ITERS steps from the del PLY plus
# REC_SAMPLES box samples with the stage-2 preset (densify at step 50, at
# the REC_DENSIFY_QUANTILE quantile of the first step's gradients);
# ctrl_inpaint runs the SD-1.5 width (context CTRL_CONTEXT, heads of 64)
# for CTRL_STEPS steps per sample.
SDS_SIZE, SDS_LATENT, SDS_ITERS = 512, 64, 60
SDS_DENSIFY = 50        # the stage-2 preset's densification interval
SDS_WEIGHT, SDS_GUIDANCE = 1e-6, 100.0
K4_2D_SHAPES = ((2, 4096, 5, 64, "float32"), (2, 1024, 10, 64, "float32"))
K4_PER_UNET2D_EVAL, K4_PER_CTRL_EVAL = 10, 14
CTRL_CONTEXT, CTRL_STEPS = 768, 10
TEXT_TOKENS = 8


# ``cuda_ms`` sleeps the device this long per timed call before starting
# its clock (the wrappers take tens of microseconds of host time each);
# the sleep counts clock cycles, at most the H100's 1.98 GHz.
HOST_LAUNCH_S = 200e-6
SLEEP_CYCLES_PER_S = 1.98e9


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(torch, fn, iters):
    """Mean device ms per call over ``iters`` back-to-back calls, after
    one warm-up call. The calls are queued behind a device-side sleep
    long enough for the host to enqueue them all (``HOST_LAUNCH_S`` per
    call), so a kernel shorter than its wrapper's host time is timed as
    the device runs it, not at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * HOST_LAUNCH_S * SLEEP_CYCLES_PER_S))
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
    shared memory, K2's blocks per SM, and K3's blocks per SM and splats
    per reduction."""
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
    k2_blocks = (ctypes.c_int * 1)()
    _kernels.check(lib.mvi_composite_residency(TILE * TILE, k2_blocks),
                   "composite_kernel residency")
    print(f"[2 build] K2 composite_kernel: {k2_blocks[0]} blocks of "
          f"{TILE * TILE} threads per SM", flush=True)
    res = (ctypes.c_int * 2)()
    _kernels.check(lib.mvi_composite_bwd_residency(TILE * TILE, res),
                   "composite_bwd_kernel residency")
    print(f"[2 build] K3 composite_bwd_kernel: {res[0]} blocks of "
          f"{TILE * TILE} threads per SM, {res[1]} splats per warp "
          f"reduction", flush=True)


def phase_kernels(torch, card, name, params, camera=None):
    """Phases 3-5 on one frame of ``camera`` (the 1080p bench camera by
    default); returns the K1 and K2 records of the kernels line (launches
    filled in later)."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        RenderCamera, api, binning, composite, composite_cuda, pair_expand)
    from multiview_inpaint_tpu_torch.utils import synthetic

    cam = RenderCamera.from_camera(camera or synthetic.bench_camera(),
                                   DEVICE)
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
    # Keys out; starts, x0, y0 and w of the actives in (the counts follow
    # from the starts and the total).
    k1_bytes = r.total * 8 + r.n_active * (8 + 4 + 4 + 4)
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

    e_rgb, e_d, e_t, bad, within = k2_verdict(torch, out_k, out_p, attrs,
                                              size)
    n_pix = e_d.numel()
    k2_ms = cuda_ms(torch, lambda: composite_cuda.composite_fwd(*k2_args),
                    10)
    with torch.no_grad():
        k2_plain_ms = cuda_ms(
            torch, lambda: composite.composite_segments(*k2_args), 1)
    walk, k2_bound = k2_bound_of(torch, *k2_args)
    k2 = dict(max_abs_err=float(max(e_rgb.max(), e_d.max(), e_t.max())),
              ms=k2_ms, plain_ms=k2_plain_ms, **k2_bound, library_ms=None)
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
    if name == "big2m":
        k2_fault(torch, card, f"4 K2 {name} planted fault", k2_args, out_p,
                 size)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    g = torch.randn(out_k.shape, generator=gen, device=DEVICE)
    g[:, 5:] = 0.0
    check_k3(torch, card, f"5 K3 {name}",
             (attrs, seg_start, counts, out_k, g, tiles_x, tiles_y, TILE,
              TILE, state), gid, params.capacity)
    return k1, k2


def k2_verdict(torch, out_k, out_p, attrs, size):
    """K2's raw tiles ``out_k`` against the plain K2's ``out_p`` as
    images of ``size`` (tiles_x, tiles_y, tile_h, tile_w, width,
    height): the per-pixel errors of rgb, depth (the sentinel through the
    final T) and T, the pixels beyond rgb 3e-5 / depth 3e-4, and whether
    every pixel lies within the stop-flip bound."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import api, composite

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
    bad = int(((e_rgb > RGB_TOL) | (e_d > DEPTH_TOL)).sum())
    # A flipped stop decision moves a pixel by at most T_in <=
    # T_STOP / (1 - 0.99) = 1e-2 times that splat's colour or depth (and
    # the depth sentinel through the final T).
    flip_t = composite.T_STOP / (1.0 - composite.ALPHA_MAX)
    c_max = float(attrs[:, 6:9].abs().max()) if attrs.shape[0] else 0.0
    d_max = float(attrs[:, 9].abs().max()) if attrs.shape[0] else 0.0
    within = bool((e_rgb <= flip_t * c_max + RGB_TOL).all()
                  and (e_d <= flip_t * (d_max + composite.DEPTH_EMPTY)
                       + DEPTH_TOL).all()
                  and (e_t <= flip_t + RGB_TOL).all())
    return e_rgb, e_d, e_t, bad, within


def k2_bound_of(torch, attrs, seg_start, counts, tiles_x, tiles_y, th, tw):
    """The walk's pair-pixel counts (``walk_counts``) and K2's
    ``bound_ms``/``bound_by`` on these inputs: its bytes (64 per pair and
    16 per tile in, 8 rows per pixel out) or its least operations."""
    walk = walk_counts(torch, attrs, seg_start, counts,
                       (tiles_x, tiles_y, th, tw))
    n_tiles = tiles_x * tiles_y
    t_bytes = (attrs.shape[0] * 64 + n_tiles * 16
               + n_tiles * 8 * th * tw * 4) / HBM_BYTES_PER_S
    return walk, bound(t_bytes, walk, K2_CONTRIB_OPS)


def k2_fault(torch, card, label, k2_args, out_p, size):
    """A planted fault that K2's bar must catch: every gate box pulled in
    by one pixel on each side (``box_shrink``), so that warps skip splats
    that some of their pixels keep. Fails if the bar passes it."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite_cuda

    with torch.no_grad():
        out_f = composite_cuda._launch(*k2_args, False, box_shrink=1.0)
    e_rgb, e_d, _, bad, within = k2_verdict(torch, out_f, out_p,
                                            k2_args[0], size)
    caught = bad > BAD_FRACTION * e_d.numel() or not within
    print(f"[{label}] K2 with every gate box pulled in by 1 px: max abs err "
          f"rgb {float(e_rgb.max()):.3g} depth {float(e_d.max()):.3g} | "
          f"{bad}/{e_d.numel()} px beyond the bar, all within the stop-flip "
          f"bound: {within} | the K2 bar "
          f"{'fails it, as it must' if caught else 'PASSES it'} | {card}",
          flush=True)
    if not caught:
        fail(f"the K2 bar does not catch gate boxes pulled in by 1 px at "
             f"{label}")


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
    pair's gaussian), K1's wrapper (its inputs are kept), ``pack_attrs``
    (a gradient hook on its output marks the end of the gather's
    backward) and K3's wrapper (its inputs are kept). Each boundary
    records a CUDA event.
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
        self.k1_args = None

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

        def k1(*a):
            self.k1_args = a
            return expand_keys(*a)

        bin_gaussians, pack_attrs = binning.bin_gaussians, api.pack_attrs
        expand_keys = binning.expand_keys
        k3_marked = marked(composite_cuda.composite_bwd, "k3_in", "k3_out")
        self.patches = [
            (gs_trainer, "render", marked(gs_trainer.render, None, "render")),
            (gs_trainer, "loss_terms",
             marked(gs_trainer.loss_terms, None, "loss")),
            (gs_trainer, "apply_adam",
             marked(gs_trainer.apply_adam, "adam_in", "adam_out")),
            (binning, "bin_gaussians", bins), (binning, "expand_keys", k1),
            (api, "pack_attrs", pack),
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
    k2_with_state(torch, card, probe)
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


def k2_with_state(torch, card, probe, label="10", cell="orbit-train"):
    """K1 and K2 on the inputs of the step ``probe`` ran (main path 2's
    first step by default): K1's keys bit-equal to the plain version's,
    K1 timed with its bound; K2 with and without the per-item state:
    tiles bit-equal, the state held against the plain K2's
    (``compare_state``), both timed, with K2's bound. Returns K1's and
    K2's records (ms, plain ms, bound)."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        composite, composite_cuda, pair_expand)

    k1_args = probe.k1_args
    same_keys = torch.equal(pair_expand.expand_keys(*k1_args),
                            pair_expand.expand_keys_ref(*k1_args))
    k1_ms = cuda_ms(torch, lambda: pair_expand.expand_keys(*k1_args), 50)
    k1_plain_ms = cuda_ms(torch,
                          lambda: pair_expand.expand_keys_ref(*k1_args), 3)
    k1_bound = (k1_args[6] * 8 + k1_args[5] * (8 + 4 + 4 + 4)) \
        / HBM_BYTES_PER_S * 1e3
    print(f"[{label} K1 {cell}] actives {k1_args[5]} pairs {k1_args[6]}: "
          f"keys equal {same_keys} | kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.4f} ms, bound {k1_bound:.4f} ms (bytes) | {card}",
          flush=True)
    if not same_keys:
        fail(f"K1 keys differ from the plain version at {cell}")
    attrs, seg_start, counts, tiles8, _, *size, state = probe.k3_args
    n_items = int(composite.item_ends(counts)[-1])  # rows past it are unset
    k2_args = (attrs.detach(), seg_start, counts, *size)
    with torch.no_grad():
        plain = composite_cuda.composite_fwd(*k2_args)
        with_st, st = composite_cuda.composite_fwd(*k2_args, with_state=True)
        ms = cuda_ms(torch, lambda: composite_cuda.composite_fwd(*k2_args),
                     10)
        ms_st = cuda_ms(torch, lambda: composite_cuda.composite_fwd(
            *k2_args, with_state=True), 10)
        k2_plain_ms = cuda_ms(
            torch, lambda: composite.composite_segments(*k2_args), 1)
        _, st_p = composite.composite_segments(*k2_args, with_state=True)
    walk, k2_bound = k2_bound_of(torch, *k2_args)
    note = compare_state(torch, f"{label} K2 {cell}", attrs, counts, st,
                         st_p)
    same = (torch.equal(plain, with_st) and torch.equal(plain, tiles8)
            and torch.equal(st[:n_items], state[:n_items]))
    print(f"[{label} K2 {cell}] tiles equal with and without the per-item "
          f"state ({tuple(st.shape)}, {st.numel() * 4 / 1e6:.1f} MB) and "
          f"equal to the step's, state equal to the step's: {same} | "
          f"{note} | kernel {ms:.4f} ms, with the state {ms_st:.4f} ms, "
          f"plain {k2_plain_ms:.2f} ms, bound {k2_bound['bound_ms']:.4f} ms "
          f"({k2_bound['bound_by']}; walked, kept, contributing share of "
          f"pair-pixels "
          f"{walk_shares(walk, attrs.shape[0] * size[2] * size[3])}) | "
          f"{card}", flush=True)
    if not same:
        fail(f"K2's tiles or state differ with the state output at {cell}")
    return (dict(ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound),
            dict(ms=ms_st, plain_ms=k2_plain_ms, **k2_bound))


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


def phase_k4(torch, card, shapes=K4_SHAPES, label="12"):
    """K4 against its plain version on packed [B, T, H*D] inputs at a
    main path's shapes (main path 3's by default); returns the record of
    each shape for the kernels line (launches filled in later). The
    launches made here are taken off the counters again."""
    import torch.nn.functional as F

    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import flash_attention as fa

    records = []
    saved = dict(_kernels.LAUNCHES)
    for b, t, h, d, dtype in shapes:
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
        print(f"[{label} K4 {dtype} [{b}, {t}, {h}*{d}], {h} heads] max abs "
              f"err "
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
    return records


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


class SeqProbe:
    """Times the real ``gen_seq`` CLI by parts: wrappers around what its
    ``main`` and ``render_sequence`` call, ``render`` and ``box_mask``
    (CUDA events around each call; ``box_mask`` also the peak device
    memory above what was allocated when it began), ``Scene`` (the load)
    and ``scene_io.save_image`` (host clock)."""

    def __init__(self, torch):
        from multiview_inpaint_tpu_torch.pipelines import gen_seq
        self.torch = torch
        self.events = {"render": [], "mask": []}   # (frame height, start, end)
        self.host_s = {"load": 0.0, "png": 0.0}
        self.png_s = {}                          # frame height: seconds
        self.peak_mb = {}

        def timed(kind, fn):
            def run(*a, **kw):
                if kind == "mask":
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
                img = out.rgb if kind == "render" else out
                h = img.shape[0]
                self.events[kind].append((h, start, end))
                if kind == "mask":
                    self.peak_mb[h] = max(self.peak_mb.get(h, 0.0), (
                        torch.cuda.max_memory_allocated() - base) / 2**20)
                return out
            return run

        def host(kind, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                dt = time.perf_counter() - t0
                self.host_s[kind] += dt
                if kind == "png":
                    h = a[1].shape[0]
                    self.png_s[h] = self.png_s.get(h, 0.0) + dt
                return out
            return run

        self.patches = [
            (gen_seq, "render", timed("render", gen_seq.render)),
            (gen_seq, "box_mask", timed("mask", gen_seq.box_mask)),
            (gen_seq, "Scene", host("load", gen_seq.Scene)),
            (gen_seq.scene_io, "save_image",
             host("png", gen_seq.scene_io.save_image))]

    def run(self, argv):
        """``gen_seq.main(argv)`` with the wrappers in place; returns its
        seconds on the host clock."""
        from multiview_inpaint_tpu_torch.pipelines import gen_seq
        saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for m, n, f in self.patches:
            setattr(m, n, f)
        try:
            t0 = time.perf_counter()
            gen_seq.main(argv)
            self.torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            for m, n, f in saved:
                setattr(m, n, f)

    def ms(self, kind):
        """{frame height: [device ms of each call]} of ``kind``."""
        out = {}
        for h, a, b in self.events[kind]:
            out.setdefault(h, []).append(a.elapsed_time(b))
        return out


def phase_stage1_setup(card):
    """Main path 5's workspace: the bench COLMAP scene, the big2m PLY (main
    path 1's, or written anew), the ``--registry`` JSON and both boxes;
    returns their paths."""
    from multiview_inpaint_tpu_torch.gs import gaussians
    from multiview_inpaint_tpu_torch.utils import synthetic

    work = os.path.join(REPO, "build", "smoke_stage1")
    shutil.rmtree(work, ignore_errors=True)
    sid = f"{STAGE1_SCENE}_{STAGE1_CASE}"
    s = dict(work=work, sid=sid, src=os.path.join(work, "scene"),
             model=os.path.join(work, "output", STAGE1_SCENE),
             ws=os.path.join(work, "ws"),
             registry=os.path.join(work, "registry.json"),
             del_box=os.path.join(work, "bds", "del", f"{STAGE1_SCENE}.obj"))
    s["box"] = os.path.join(s["ws"], "bds", "add", f"{sid}.obj")
    s["ply"] = os.path.join(s["model"], "point_cloud", "iteration_1",
                            "point_cloud.ply")
    names = synthetic.write_bench_colmap_scene(s["src"], YAWS)
    main_ply = os.path.join(REPO, "build", "smoke", "model", "point_cloud",
                            "iteration_1", "point_cloud.ply")
    os.makedirs(os.path.dirname(s["ply"]))
    if os.path.exists(main_ply):
        shutil.copy(main_ply, s["ply"])
    else:
        gaussians.save_ply(synthetic.make_big_scene(BIG_N, device="cpu"),
                           s["ply"])
    front = os.path.splitext(names[0])[0]
    with open(s["registry"], "w") as f:
        json.dump({"front_views": {STAGE1_SCENE: front},
                   "orbit_params": {STAGE1_SCENE: STAGE1_ORBIT},
                   "vis_params": {STAGE1_SCENE: STAGE1_ORBIT}}, f)
    synthetic.write_cube_obj(s["box"], center=INSERT_CENTER,
                             half=INSERT_HALF)
    synthetic.write_cube_obj(s["del_box"], center=DELETE_CENTER,
                             half=DELETE_HALF)
    print(f"[20 stage-1 setup] scene {sid}: the bench COLMAP scene "
          f"({len(names)} views at 1920x1080), the big2m PLY ({BIG_N} "
          f"gaussians), registry front view {front} (the bench camera at "
          f"z = -3 looking down +z) with the bicycle scene's orbit and vis "
          f"parameters {json.dumps(STAGE1_ORBIT)}; insertion box centre "
          f"{INSERT_CENTER}, half {INSERT_HALF}, at the front of the "
          f"foreground clusters near the origin (phase 22 prints the share "
          f"of its front-view pixels the scene hides); deletion box centre "
          f"{DELETE_CENTER}, half {DELETE_HALF} | {card}", flush=True)
    return s


def _stage1_argv(s):
    return ["-s", s["src"], "-m", s["model"], "--scene_id", s["sid"],
            "--workspace", s["ws"], "--registry", s["registry"],
            "--resolution", "1", "--device", DEVICE]


def _png_array(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


def _forward_launches(n):
    return {"pair_expand": n, "composite": n, "composite_bwd": 0,
            "flash_attn_fwd": 0, "flash_attn_bwd": 0}


def phase_gen_seq(torch, card, s):
    """Main path 5: the gen_seq CLI on big2m, counters zeroed before; then
    the same CLI run again under ``SeqProbe`` for its time split. Returns
    the launch counts of the first run."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.gs import obb
    from multiview_inpaint_tpu_torch.pipelines import gen_seq

    argv = _stage1_argv(s)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    gen_seq.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    n_train = len(YAWS)
    want = len(SEQ_MODES) * SEQ_FRAMES + n_train

    def seq(mode):
        return os.path.join(s["ws"], "inpaint", "seq", s["sid"], mode,
                            "ours_1")

    center = obb.load_obb(s["box"]).center
    checks = {f"K1 and K2 launched {want} times, K3-K5 0":
              launches == _forward_launches(want)}
    cover = {}
    for mode in SEQ_MODES:
        d = seq(mode)
        shapes = {"renders": (ORBIT_H, ORBIT_W, 3), "mask": (ORBIT_H, ORBIT_W),
                  "masked": (ORBIT_H, ORBIT_W, 3)}
        masks = []
        for sub, shape in shapes.items():
            names = sorted(os.listdir(os.path.join(d, sub)))
            arrs = [_png_array(os.path.join(d, sub, n)) for n in names]
            checks[f"{mode} {len(arrs)} {sub} at {shape}"] = (
                len(arrs) == SEQ_FRAMES
                and all(a.shape == shape for a in arrs))
            if sub == "mask":
                masks = [a > 0 for a in arrs]
        cover[mode] = [round(float(m.mean()), 4) for m in masks]
        checks[f"{mode} masks non-empty in a frame, not all ones in all"] = (
            any(m.any() for m in masks) and not all(m.all() for m in masks))
        checks[f"{mode} poses (14, 4, 4)"] = np.load(os.path.join(
            d, "poses.npy")).shape == (SEQ_FRAMES, 4, 4)
        checks[f"{mode} cam_center at the box centre"] = bool(np.abs(
            np.load(os.path.join(d, "cam_center.npy"))[0]
            - center).max() <= 1e-5)
    bds = os.path.join(seq("bds_train"), "mask")
    bds_masks = [_png_array(os.path.join(bds, n))
                 for n in sorted(os.listdir(bds))]
    checks[f"bds_train {n_train} masks at 1920x1080"] = (
        len(bds_masks) == n_train
        and all(m.shape == (1080, 1920) for m in bds_masks))

    probe = SeqProbe(torch)
    probe_s = probe.run(argv)
    render_ms, mask_ms = probe.ms("render"), probe.ms("mask")
    orbit, full = render_ms.get(ORBIT_H, []), render_ms.get(1080, [])
    split = {"load_s": probe.host_s["load"],
             "render_s": (sum(orbit) + sum(full)) / 1e3,
             "mask_s": sum(sum(v) for v in mask_ms.values()) / 1e3,
             "png_s": probe.host_s["png"]}
    split["other_s"] = probe_s - sum(split.values())
    checks["probed run rendered every frame"] = (
        len(orbit) == len(SEQ_MODES) * SEQ_FRAMES and len(full) == n_train)
    print(f"[21 main gen_seq] gen_seq CLI, {BIG_N} gaussians, modes "
          f"{list(SEQ_MODES)} x {SEQ_FRAMES} frames at {ORBIT_H}x{ORBIT_W} "
          f"(HxW) + {n_train} bds_train views at 1920x1080, in {cli_s:.2f} s "
          f"(PNGs written) | launches {launches} | mask cover per frame "
          f"{json.dumps(cover)} | probed run {probe_s:.2f} s: "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})}, PNG "
          f"share {split['png_s'] / probe_s:.3f}, PNG s by frame height "
          f"{json.dumps({k: round(v, 3) for k, v in probe.png_s.items()})} "
          f"| device ms per orbit frame "
          f"(CUDA events) median {statistics.median(orbit or [0]):.3f} (all "
          f"{[round(t, 2) for t in orbit]}), per 1080p view median "
          f"{statistics.median(full or [0]):.3f} | mask ms per frame median "
          f"{ORBIT_H}x{ORBIT_W} "
          f"{statistics.median(mask_ms.get(ORBIT_H, [0])):.3f}, 1080p "
          f"{statistics.median(mask_ms.get(1080, [0])):.3f} | OBB step peak "
          f"device memory above its start (MB) "
          f"{json.dumps({k: round(v, 1) for k, v in probe.peak_mb.items()})}"
          f" | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 5 (gen_seq CLI) checks failed: {checks}")
    return launches


def _render_route(torch, params, cam, k2=None):
    """``api.render`` of ``cam`` with its K2 call replaced by ``k2``
    (None: K2 itself)."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import api
    real = api.composite_tiles
    if k2 is not None:
        api.composite_tiles = k2
    try:
        with torch.no_grad():
            return api.render(params, cam, torch.zeros(3, device=DEVICE),
                              device=DEVICE)
    finally:
        api.composite_tiles = real


def sentinel_counts(depth_a, depth_b):
    """Pixels at exactly the empty-pixel depth 15.0 in each image; the
    ``gen_seq`` mask needs both counts equal."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import DEPTH_EMPTY
    return (int((depth_a == DEPTH_EMPTY).sum()),
            int((depth_b == DEPTH_EMPTY).sum()))


def phase_mask_plain(torch, card, s):
    """The gen_seq mask through K1/K2 against the plain K2's route on the
    card, for frame 0 of x1 and the front view at 1080p (and the front
    view of the foreground clusters alone, which has empty pixels): equal
    sentinel counts, masks that differ only where t lies between the two
    depths within K2's stop-flip bound, and the box hit on CUDA against
    the CPU off fragile rays; then a planted fault (K2's empty pixels at
    a final T of 1 - 2^-24) that the sentinel check must fail."""
    from multiview_inpaint_tpu_torch.config import registries
    from multiview_inpaint_tpu_torch.gs import gaussians, obb
    from multiview_inpaint_tpu_torch.gs import scene as scene_mod
    from multiview_inpaint_tpu_torch.gs.cameras import get_rays
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        DEPTH_EMPTY, RenderCamera, api, composite)
    from multiview_inpaint_tpu_torch.pipelines import gen_seq

    registries.load_registry_overrides(s["registry"])
    sc = scene_mod.Scene(s["src"], s["model"], resolution=1, shuffle=False,
                         load_gaussians=False)
    sc.scene_name = s["sid"]
    front = sc.front_view()
    box = obb.load_obb(s["box"])
    o = registries.get_orbit_params(STAGE1_SCENE)
    orbit0 = scene_mod.orbit_cameras(
        front, box, mode="x1", frames=SEQ_FRAMES, view_range=o.view_range,
        r_scale=o.r_scale, k_lift=o.k_lift, k_bias=o.k_bias)[0]
    params = gaussians.load_ply(s["ply"], 0, device=DEVICE)
    # make_big_scene's first 55% of rows are the foreground clusters; alone
    # (ground plane and far shell dead) they leave the front view's edges
    # empty, where the sentinel must hold.
    live = params.live.clone()
    live[int(BIG_N * 0.55):] = False
    clusters = dataclasses.replace(params, live=live)
    flip_t = composite.T_STOP / (1.0 - composite.ALPHA_MAX)

    def plain_k2(*a):
        return composite.composite_segments(*a)

    frames = (("x1 frame 0", orbit0, params, True),
              ("bds_train view00", front, params, True),
              ("view00, the clusters alone", front, clusters, False))
    checks, notes = {}, {}
    for name, view, p, hits in frames:
        cam = RenderCamera.from_camera(view, DEVICE)
        out_k = _render_route(torch, p, cam)
        out_p = _render_route(torch, p, cam, plain_k2)
        d_k, d_p = out_k.depth, out_p.depth
        n_k, n_p = sentinel_counts(d_k, d_p)
        with torch.no_grad():
            m_k = gen_seq.box_mask(view, box, d_k)
            m_p = gen_seq.box_mask(view, box, d_p)
            proj = api.project(p, cam, 0)
            d_max = float(proj.depth[proj.radius > 0].max())
        rays_o, rays_d = get_rays(view)
        _, t, hit = obb.intersect(box, torch.from_numpy(rays_o).to(DEVICE),
                                  torch.from_numpy(rays_d).to(DEVICE))
        t = t.reshape(view.height, view.width)
        bound = flip_t * (d_max + DEPTH_EMPTY) + DEPTH_TOL
        explained = (((t < d_k) != (t < d_p))
                     & ((d_k - d_p).abs() <= bound))
        differ = m_k != m_p
        note = dict(sentinel=[n_k, n_p], mask_px=int(m_k.sum()),
                    masks_differ=int(differ.sum()),
                    unexplained=int((differ & ~explained).sum()))
        checks[f"{name}: sentinel counts equal"] = n_k == n_p
        checks[f"{name}: masks differ only across t within the stop-flip "
               f"bound"] = note["unexplained"] == 0
        if hits:
            _, _, hit_c = obb.intersect(box, torch.from_numpy(rays_o),
                                        torch.from_numpy(rays_d))
            fragile = torch.from_numpy(obb.fragile_rays(box, rays_o,
                                                        rays_d))
            hit_differ = hit.cpu() != hit_c
            note.update(box_hits=int(hit.sum()), fragile_rays=int(
                fragile.sum()), hits_differ_cuda_cpu=int(hit_differ.sum()))
            checks[f"{name}: CUDA and CPU hits differ only on fragile "
                   f"rays"] = not bool((hit_differ & ~fragile).any())
        if view is front and p is params:
            hidden = 1.0 - float(m_k.sum()) / max(int(hit.sum()), 1)
            note["front_hidden_share"] = round(hidden, 4)
            checks["the box is partly hidden in the front view"] = (
                0.0 < hidden < 1.0)
        notes[name] = note
    checks["the clusters alone leave empty pixels"] = (
        notes[frames[2][0]]["sentinel"][1] > 0)

    real_k2 = api.composite_tiles

    def faulty_k2(*a):
        t8 = real_k2(*a).clone()
        t_fin = t8[:, 4, :]
        t8[:, 4, :] = torch.where(t_fin == 1.0,
                                  torch.full_like(t_fin, 1.0 - 2.0 ** -24),
                                  t_fin)
        return t8

    # The planted fault on the clusters alone, against their plain route.
    cam = RenderCamera.from_camera(front, DEVICE)
    d_f = _render_route(torch, clusters, cam, faulty_k2).depth
    d_p = _render_route(torch, clusters, cam, plain_k2).depth
    n_f, n_p = sentinel_counts(d_f, d_p)
    empty = d_p == DEPTH_EMPTY
    d_fault = float(d_f[empty].max()) if n_p else float("nan")
    caught = n_f != n_p
    print(f"[22 mask] the gen_seq mask through K1/K2 against the plain K2 on "
          f"the card, the box hit on CUDA against the CPU (fragile: within "
          f"{obb.FRAGILE_TOL} of a triangle edge, obb.fragile_rays): "
          f"{json.dumps(notes)} | planted fault, K2's empty pixels at final "
          f"T 1 - 2^-24 (depth {d_fault:.7f} there): sentinel counts "
          f"{n_f} vs {n_p}, the sentinel check "
          f"{'fails it, as it must' if caught else 'PASSES it'} | "
          f"{json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 5's mask disagrees with its plain route: {checks}")
    if not caught:
        fail("the sentinel check does not catch a final T of 1 - 2^-24")
    # K1-K3 against their plain versions at the orbit frame's shapes, as
    # phases 3-5 hold them at 1080p.
    phase_kernels(torch, card, f"orbit{ORBIT_H}x{ORBIT_W}", params, orbit0)


def phase_stage1_clis(torch, card, s):
    """Main path 5's other renderers: the render_depth CLI (both modes)
    and the vis_render CLI with --src (a 56-frame sweep) on big2m,
    counters zeroed before each; returns their launch counts."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.pipelines import render_depth, vis_render

    seq = os.path.join(s["ws"], "inpaint", "seq", s["sid"])
    n_seq = len(SEQ_MODES) * SEQ_FRAMES
    runs = (("render_depth", render_depth.main, [], n_seq,
             [os.path.join(seq, m, "ours_1", "disp") for m in SEQ_MODES],
             (ORBIT_H, ORBIT_W)),
            ("vis_render --src", vis_render.main,
             ["--src", "--iteration", "1"], VIS_FRAMES - 1,
             [os.path.join(s["ws"], "vis", "vis_video", "src", s["sid"],
                           "renders")], (ORBIT_H, ORBIT_W, 3)))
    out = {}
    for name, main, extra, want, dirs, shape in runs:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        main(_stage1_argv(s) + extra)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        pngs = [os.path.join(d, n) for d in dirs
                for n in sorted(os.listdir(d))]
        arrs = [_png_array(p) for p in pngs]
        checks = {f"K1 and K2 launched {want} times, K3-K5 0":
                  launches == _forward_launches(want),
                  f"{want} PNGs at {shape}": len(arrs) == want and all(
                      a.shape == shape for a in arrs),
                  "no constant PNG": all(a.std() > 0 for a in arrs)}
        print(f"[23 {name}] {name} CLI, {BIG_N} gaussians, {want} frames at "
              f"{ORBIT_H}x{ORBIT_W} in {cli_s:.2f} s, "
              f"{cli_s * 1e3 / want:.1f} ms per frame (PNGs written) | "
              f"launches {launches} | {json.dumps(checks)} | {card}",
              flush=True)
        if not all(checks.values()):
            fail(f"main path 5 ({name} CLI) checks failed: {checks}")
        out[name] = launches
    return out


def phase_delete_gen_pc(torch, card, s):
    """Main path 5's point tools on the big2m PLY: the delete CLI with a
    box inside the scene (nothing left inside; contains on CUDA against
    the CPU off fragile rows) and the gen_pc CLI (10,000 points)."""
    from multiview_inpaint_tpu_torch.gs import obb, ply_io
    from multiview_inpaint_tpu_torch.pipelines import delete, gen_pc

    xyz = ply_io.load_gaussian_ply(s["ply"], 0)["xyz"]
    t0 = time.perf_counter()
    delete.main(["-m", s["model"], "--box", s["del_box"], "--iteration", "1",
                 "--device", DEVICE])
    torch.cuda.synchronize()
    del_s = time.perf_counter() - t0
    kept = ply_io.load_gaussian_ply(os.path.join(
        s["model"], "point_cloud", "del", "point_cloud.ply"), 0)["xyz"]
    box = obb.load_obb(s["del_box"])
    with torch.no_grad():
        left = int(obb.contains(box, torch.from_numpy(kept).to(DEVICE)).sum())
        in_cuda = obb.contains(box, torch.from_numpy(xyz).to(DEVICE)).cpu()
        in_cpu = obb.contains(box, torch.from_numpy(xyz))
    dx = np.zeros_like(xyz)
    dx[:, 0] = 1.0
    fragile = torch.from_numpy(obb.fragile_rays(box, xyz, dx)
                               | obb.fragile_rays(box, xyz, -dx))
    differ = in_cuda != in_cpu
    removed = len(xyz) - len(kept)
    t0 = time.perf_counter()
    gen_pc.main(["-m", s["model"], "--iteration", "1"])
    pc_s = time.perf_counter() - t0
    pts, _, _ = ply_io.fetch_point_cloud(os.path.join(s["model"], "xyz.ply"))
    checks = {"removed > 0": removed > 0,
              "removed = contains on CUDA": removed == int(in_cuda.sum()),
              "none left inside": left == 0,
              "contains CUDA = CPU off fragile rows":
              not bool((differ & ~fragile).any()),
              "gen_pc wrote 10000 points": len(pts) == 10000}
    print(f"[24 delete, gen_pc] delete CLI on {len(xyz)} gaussians in "
          f"{del_s:.2f} s: {removed} removed, {left} left inside | contains "
          f"CUDA vs CPU: {int(differ.sum())} rows differ, "
          f"{int(fragile.sum())} "
          f"within {obb.FRAGILE_TOL} of a face | gen_pc CLI in {pc_s:.2f} s, "
          f"{len(pts)} points | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 5 (delete, gen_pc CLIs) checks failed: {checks}")


def _orbit_views(s, mode):
    """The orbit cameras gen_seq rendered for ``mode`` (main path 5)."""
    from multiview_inpaint_tpu_torch.config import registries
    from multiview_inpaint_tpu_torch.gs import obb
    from multiview_inpaint_tpu_torch.gs import scene as scene_mod

    registries.load_registry_overrides(s["registry"])
    sc = scene_mod.Scene(s["src"], s["model"], resolution=1, shuffle=False,
                         load_images=False, load_gaussians=False)
    sc.scene_name = s["sid"]
    o = registries.get_orbit_params(STAGE1_SCENE)
    return scene_mod.orbit_cameras(
        sc.front_view(), obb.load_obb(s["box"]), mode=mode,
        frames=SEQ_FRAMES, view_range=o.view_range, r_scale=o.r_scale,
        k_lift=o.k_lift, k_bias=o.k_bias)


def _seq_dir(s, mode, ctrl=None, kind="seq"):
    from multiview_inpaint_tpu_torch.gs.scene import Workspace
    ws = Workspace(s["ws"])
    if kind == "seq":
        return ws.seq_dir(s["sid"], mode, 1)
    return getattr(ws, f"{kind}_dir")(s["sid"], ctrl, mode)


def phase_stage2_frames(torch, card, s):
    """Main path 6's stand-in for svd_test's frames: big2m and a
    saturated object of OBJECT_N splats inside the insertion box rendered
    together through ``render`` (K1/K2) at the 28 orbit poses, written as
    ctrl 0's inpainted PNGs; returns each frame's visible-object mask (the
    object's own alpha > 0.5 where its depth is nearer than big2m's) and
    the orbit fov."""
    from multiview_inpaint_tpu_torch.gs import gaussians, scene_io
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        DEPTH_EMPTY, RenderCamera, render)
    from multiview_inpaint_tpu_torch.utils import sh, synthetic

    t0 = time.perf_counter()
    big = gaussians.load_ply(s["ply"], 0, device=DEVICE)
    obj = synthetic.make_gt_gaussians(n=OBJECT_N, seed=7,
                                      spread=OBJECT_SPREAD, device=DEVICE)
    n = OBJECT_N
    dc = torch.as_tensor(sh.rgb_to_sh(np.asarray(OBJECT_RGB, np.float32)),
                         dtype=torch.float32, device=DEVICE)
    both = gaussians.from_arrays(
        torch.cat([big.xyz, obj.xyz + torch.tensor(INSERT_CENTER,
                                                   device=DEVICE)]),
        torch.cat([big.features_dc, dc.expand(n, 1, 3)]),
        torch.cat([big.features_rest, obj.features_rest]),
        torch.cat([big.opacity, torch.full(
            (n, 1), math.log(OBJECT_OPACITY / (1 - OBJECT_OPACITY)),
            device=DEVICE)]),
        torch.cat([big.scaling, torch.full((n, 3), math.log(OBJECT_SCALE),
                                           device=DEVICE)]),
        torch.cat([big.rotation, obj.rotation]), device=DEVICE)
    live = torch.zeros_like(both.live)
    live[len(big.xyz):] = True
    alone = dataclasses.replace(both, live=live)
    black = torch.zeros(3, device=DEVICE)
    visible, png_s, render_ms = {}, 0.0, []
    fov = None
    for mode in SEQ_MODES:
        views = _orbit_views(s, mode)
        poses = np.load(os.path.join(_seq_dir(s, mode), "poses.npy"))
        if not np.array_equal(np.stack([v.camera_to_world for v in views])
                              .astype(np.float32), poses):
            fail(f"main path 6: the orbit cameras of {mode} are not "
                 f"gen_seq's poses")
        fov = (views[0].fovx, views[0].fovy)
        out_dir = _seq_dir(s, mode, 0, "inpainted")
        for i, view in enumerate(views):
            cam = RenderCamera.from_camera(view, DEVICE)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.no_grad():
                start.record()
                img = render(both, cam, black, device=DEVICE).rgb
                end.record()
                o = render(alone, cam, black, device=DEVICE)
                b = render(big, cam, black, device=DEVICE)
            a = o.alpha.clamp(min=1e-6)
            d_obj = (o.depth - (1 - o.alpha) * DEPTH_EMPTY) / a
            visible[(mode, i)] = ((o.alpha > 0.5) & (d_obj < b.depth)
                                  ).cpu().numpy()
            t1 = time.perf_counter()
            scene_io.save_image(os.path.join(out_dir, f"{i:02d}.png"),
                                img.cpu().numpy())
            png_s += time.perf_counter() - t1
            render_ms.append(start.elapsed_time(end))
    cover = [round(float(v.mean()), 4) for v in visible.values()]
    print(f"[25 stage-2 frames] big2m + a {OBJECT_N}-splat object of colour "
          f"{OBJECT_RGB} (spread {OBJECT_SPREAD}, scale {OBJECT_SCALE}, "
          f"opacity {OBJECT_OPACITY}) at the insertion box centre, rendered "
          f"together at {len(visible)} orbit poses ({ORBIT_H}x{ORBIT_W}) "
          f"into ctrl 0's inpainted frames in "
          f"{time.perf_counter() - t0:.2f} s (PNG {png_s:.2f} s; device ms "
          f"per frame median {statistics.median(render_ms):.3f}) | visible "
          f"object cover per frame {cover} | {card}", flush=True)
    if sum(c > 0.002 for c in cover) < len(cover) // 2:
        fail(f"main path 6: the object is visible in fewer than half the "
             f"frames: {cover}")
    return visible, fov


def _mask_png(path):
    return _png_array(path) > 127


def phase_seg_auto(torch, card, s, visible, fov):
    """Main path 6: the seg_masks CLI with --auto --propagate on modes x1
    and x2 (14 frames each, the orbit fov), IoU of each frame's mask
    against the object's visible mask; median above SEG_IOU_BAR."""
    from multiview_inpaint_tpu_torch.pipelines import seg_masks

    t0 = time.perf_counter()
    seg_masks.main(["--scene_id", s["sid"], "--ctrl_id", "0", "--modes",
                    *SEQ_MODES, "--frames", str(SEQ_FRAMES), "--iteration",
                    "1", "--workspace", s["ws"], "--auto", "--propagate",
                    "--fovx", repr(fov[0]), "--fovy", repr(fov[1]),
                    "--device", DEVICE])
    cli_s = time.perf_counter() - t0
    def iou(a, b):
        union = float((a | b).sum())
        return round(float((a & b).sum()) / union if union else 1.0, 4)

    ious, box_ious = {}, []
    for (mode, i), want in visible.items():
        got = _mask_png(os.path.join(_seq_dir(s, mode, 0, "sam_mask"),
                                     f"{i:02d}.png"))
        ious[f"{mode}/{i:02d}"] = iou(got, want)
        box_ious.append(iou(_mask_png(os.path.join(
            _seq_dir(s, mode), "mask", f"{i:02d}.png")), want))
    med = statistics.median(ious.values())
    worst = min(ious, key=ious.get)
    print(f"[26 seg_masks auto] seg_masks CLI --auto --propagate, modes "
          f"{list(SEQ_MODES)} x {SEQ_FRAMES} frames in {cli_s:.2f} s "
          f"({cli_s * 1e3 / len(ious):.1f} ms per frame) | IoU against the "
          f"visible object per frame {json.dumps(ious)} | median {med:.4f} "
          f"(bar > {SEG_IOU_BAR}), worst {worst} {ious[worst]:.4f} | the "
          f"box mask's own IoU median {statistics.median(box_ious):.4f} | "
          f"{card}", flush=True)
    if not med > SEG_IOU_BAR:
        fail(f"main path 6: seg_masks --auto --propagate median IoU {med} "
             f"<= {SEG_IOU_BAR}")


def _clip_towers(torch):
    """Full-width random CLIP towers on the card: every all-zero
    parameter moved, q and k projections scaled by SVD_QK_GAIN."""
    from multiview_inpaint_tpu_torch.diffusion.clip_text import (
        CLIPTextTower, TextConfig)
    from multiview_inpaint_tpu_torch.diffusion.clip_vit import (
        CLIPVisionTower, ViTConfig)

    torch.manual_seed(0)
    towers = []
    for seed, tower in enumerate((CLIPVisionTower(ViTConfig(), device=DEVICE),
                                  CLIPTextTower(TextConfig(),
                                                device=DEVICE))):
        perturb_zero_params(torch, tower, 10 + seed)
        with torch.no_grad():
            for blk in tower.transformer.resblocks:
                w = blk.attn.in_proj_weight.shape[1]
                blk.attn.in_proj_weight[:2 * w] *= SVD_QK_GAIN
                blk.attn.in_proj_bias[:2 * w] *= SVD_QK_GAIN
        towers.append(tower.eval().requires_grad_(False))
    return towers


def phase_seg_ground(torch, card, s):
    """Main path 6: seg_masks --ground at full width on mode x1 (ctrl 1):
    the towers written as a JAX-layout npz, a merges file, a plain-text
    query; every grounded mask within the same frame's --auto mask; the 57
    window scores of frame 0 against the same towers in float64 on the
    card at GROUND_WINDOWS; ms per frame and peak device memory."""
    import copy

    from multiview_inpaint_tpu_torch.diffusion import checkpoint
    from multiview_inpaint_tpu_torch.gs import scene_io
    from multiview_inpaint_tpu_torch.guidance import grounding
    from multiview_inpaint_tpu_torch.pipelines import seg_masks

    t0 = time.perf_counter()
    vis, text = _clip_towers(torch)
    n_params = sum(p.numel() for t in (vis, text) for p in t.parameters())
    npz = os.path.join(s["work"], "clip.npz")
    merges = os.path.join(s["work"], "merges.txt")
    with open(merges, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(GROUND_MERGES) + "\n")
    checkpoint.save_params(npz, {
        "vit_cfg": {k: np.asarray(v)
                    for k, v in dataclasses.asdict(vis.cfg).items()},
        "vision": checkpoint.state_dict_to_jax(
            {checkpoint.PREFIXES["clip"] + k: v
             for k, v in vis.state_dict().items()}, "clip"),
        "text": checkpoint.state_dict_to_jax(
            {checkpoint.TEXT_PREFIX + k: v
             for k, v in text.state_dict().items()}, "clip_text")})
    write_s = time.perf_counter() - t0
    src = _seq_dir(s, "x1", 0, "inpainted")
    dst = _seq_dir(s, "x1", 1, "inpainted")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    argv = ["--scene_id", s["sid"], "--ctrl_id", "1", "--modes", "x1",
            "--frames", str(SEQ_FRAMES), "--iteration", "1", "--workspace",
            s["ws"], "--auto", "--device", DEVICE]
    seg_masks.main(argv)
    out = _seq_dir(s, "x1", 1, "sam_mask")
    auto = [_mask_png(os.path.join(out, f"{i:02d}.png"))
            for i in range(SEQ_FRAMES)]
    real_load = seg_masks.load_grounder
    load_s = []

    def timed_load(*a):
        t = time.perf_counter()
        g = real_load(*a)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t)
        return g

    seg_masks.load_grounder = timed_load
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    t0 = time.perf_counter()
    try:
        seg_masks.main(argv + ["--ground", GROUND_QUERY, "--clip_ckpt", npz,
                               "--bpe_vocab", merges])
        torch.cuda.synchronize()
    finally:
        seg_masks.load_grounder = real_load
    cli_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20 - base_mb
    grounded = [_mask_png(os.path.join(out, f"{i:02d}.png"))
                for i in range(SEQ_FRAMES)]
    subset = all(not (g & ~a).any() for g, a in zip(grounded, auto))
    kept = [round(float(g.sum()) / max(float(a.sum()), 1.0), 4)
            for g, a in zip(grounded, auto)]

    # Frame 0's window scores in f32 against the same towers in f64.
    img = scene_io.load_image(os.path.join(src, "00.png"))
    g32 = grounding.CLIPGrounder(vis, text, merges)
    wins = grounding.grounding_windows(*img.shape[:2])
    _, s32 = g32(img, GROUND_QUERY)
    g64 = grounding.CLIPGrounder(copy.deepcopy(vis).double(),
                                 copy.deepcopy(text).double(), merges)
    pick = wins[list(GROUND_WINDOWS)]
    s64 = g64.scores(g64.crops(img, pick),
                     g64.text_features(GROUND_QUERY)).cpu().numpy()
    err = np.abs(s32[list(GROUND_WINDOWS)] - s64)
    rel = float(err.max() / np.abs(s64).max())
    del g64
    torch.cuda.empty_cache()
    frame_ms = (cli_s - sum(load_s)) * 1e3 / SEQ_FRAMES
    checks = {f"{len(wins)} windows at {ORBIT_H}x{ORBIT_W}": len(wins) == 57,
              "grounded masks within the auto masks": subset,
              f"f32 scores within {GROUND_REL_TOL} of max|f64|":
              rel <= GROUND_REL_TOL}
    print(f"[27 seg_masks ground] towers {n_params / 1e9:.3f}B f32 "
          f"parameters (ViT-H/14 + 23-layer text), npz written in "
          f"{write_s:.2f} s ({os.path.getsize(npz) / 2**30:.2f} GiB) | "
          f"seg_masks --ground {GROUND_QUERY!r} on x1 in {cli_s:.2f} s: "
          f"towers loaded in {sum(load_s):.2f} s, {frame_ms:.1f} ms per "
          f"frame, peak device memory {peak_mb:.0f} MB above its start | "
          f"share of the auto mask kept per frame {kept} | frame 0 scores "
          f"f32 vs f64 at windows {list(GROUND_WINDOWS)}: f64 "
          f"{[round(float(v), 5) for v in s64]}, max abs err "
          f"{float(err.max()):.3g}, relative to max|f64| {rel:.3g} (bar "
          f"{GROUND_REL_TOL}); best window {wins[int(np.argmax(s32))].tolist()}"
          f" | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 6 (seg_masks --ground) checks failed: {checks}")


class RecProbe:
    """Wraps ``gs_trainer.train_step`` as the inpaint_rec CLI calls it:
    each step's loss mode, image height, loss and CUDA events."""

    def __init__(self, torch):
        from multiview_inpaint_tpu_torch.models import gs_trainer
        self.torch, self.steps, self.real = torch, [], gs_trainer.train_step

    def __enter__(self):
        from multiview_inpaint_tpu_torch.models import gs_trainer
        torch = self.torch

        def step(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real(*a, **kw)
            end.record()
            self.steps.append((kw.get("loss_mode", "full"), a[2].shape[0],
                               out[1].loss, start, end))
            return out

        gs_trainer.train_step = step
        return self

    def __exit__(self, *exc):
        from multiview_inpaint_tpu_torch.models import gs_trainer
        gs_trainer.train_step = self.real

    def by_kind(self):
        """{(loss mode, height): ([losses], [ms])} in step order."""
        out = {}
        for mode, h, loss, a, b in self.steps:
            losses, ms = out.setdefault((mode, h), ([], []))
            losses.append(float(loss))
            ms.append(a.elapsed_time(b))
        return out


def _rec_scene(s):
    from multiview_inpaint_tpu_torch.config import registries
    from multiview_inpaint_tpu_torch.gs.scene import Scene, Workspace

    registries.load_registry_overrides(s["registry"])
    sc = Scene(s["src"], s["model"], resolution=1, shuffle=False,
               workspace=Workspace(s["ws"]), load_gaussians=False,
               device=DEVICE)
    sc.scene_name = s["sid"]
    return sc


def phase_stage2_step(torch, card, s):
    """Main path 6: one stage-2 step of each kind on load_sd_ply's rows
    before the CLI: a 512x384 seq view with the full loss and a 1080p
    training view with the background loss (``StepProbe``), K3 held
    against the plain K3 (``check_k3``), K1 and K2 against theirs
    (``k2_with_state``), the pairs whose K3 rows are all zero and the
    pixels whose cotangent is; returns the densification threshold and
    the kernels' records of both shapes."""
    from multiview_inpaint_tpu_torch.gs import obb, ply_io
    from multiview_inpaint_tpu_torch.gs import scene as scene_mod
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera,
                                                            composite_cuda)

    sc = _rec_scene(s)
    cams = scene_mod.inpaint_train_cameras(sc, n_mode=2, ctrl_id=0,
                                           frames=SEQ_FRAMES, iteration=1)
    n_seq = sum(c.inpainted for c in cams)
    del_ply = os.path.join(s["model"], "point_cloud", "del",
                           "point_cloud.ply")
    n_del = len(ply_io.load_gaussian_ply(del_ply, 0)["xyz"])
    t0 = time.perf_counter()
    params = scene_mod.load_sd_ply(del_ply, obb.load_obb(s["box"]),
                                   n_samples=REC_SAMPLES, device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_rows = int(params.num_live())
    state = gs_trainer.init_state(params)
    cfg = gs_trainer.OptimizationConfig()
    bg = torch.zeros(3, device=DEVICE)
    records, threshold = {}, None
    for kind, cam in (("seq", next(c for c in cams if c.inpainted)),
                      ("train_1080p", next(c for c in cams
                                           if not c.inpainted))):
        mode = "full" if cam.inpainted else "background"
        gt = torch.as_tensor(np.asarray(cam.image, np.float32),
                             device=DEVICE)
        mask = (None if cam.inpainted else torch.as_tensor(
            np.asarray(cam.mask, np.float32), device=DEVICE))
        torch.cuda.reset_peak_memory_stats()
        probe = StepProbe(torch)
        (state, m), split = probe.step(
            state, RenderCamera.from_camera(cam, DEVICE), gt, bg, cfg,
            sc.cameras_extent, 0, mask, mode)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        label = f"28 {kind} {cam.width}x{cam.height} {mode}"
        k3 = check_k3(torch, card, f"{label} K3", probe.k3_args, probe.gid,
                      state.params.capacity)
        k1, k2 = k2_with_state(torch, card, probe, "28", f"orbit-rec {kind}")
        with torch.no_grad():
            d_k = composite_cuda.composite_bwd(*probe.k3_args)
        zero_rows = int((d_k[:, :10] == 0).all(dim=1).sum())
        g = probe.k3_args[4]
        zero_px = float((g[:, :5] == 0).all(dim=1).float().mean())
        records[kind] = dict(K1=k1, K2=k2, K3=k3)
        print(f"[{label}] {n_rows} rows in {state.params.capacity} "
              f"(load_sd_ply in {load_s:.2f} s), pairs {m.pairs}, loss "
              f"{float(m.loss):.5f}, non-finite gradients "
              f"{int(m.nonfinite_grads)} | pairs with all-zero K3 rows "
              f"{zero_rows} of {d_k.shape[0]} ({zero_rows / d_k.shape[0]:.4f})"
              f", tile pixels with a zero cotangent {zero_px:.4f} | split "
              f"(ms) {json.dumps({k: round(v, 3) for k, v in split.items()})}"
              f" | peak device memory {peak_gb:.2f} GB | {card}", flush=True)
        if int(m.nonfinite_grads) or not torch.isfinite(m.loss):
            fail(f"main path 6 step {label}: non-finite loss or gradients")
        if threshold is None:
            seen = state.stats.denom > 0
            threshold = float(torch.quantile(
                state.stats.grad_accum[seen][:2**24], REC_DENSIFY_QUANTILE))
    checks = {f"{REC_CAMERAS} cameras per epoch": len(cams) == REC_CAMERAS,
              "27 of them seq views": n_seq == 27,
              f"the del PLY's {n_del} rows + {REC_SAMPLES}":
              n_rows == n_del + REC_SAMPLES}
    print(f"[28 stage-2 steps] {json.dumps(checks)} | densify threshold "
          f"{threshold:.4g} (the {REC_DENSIFY_QUANTILE} quantile of the seq "
          f"step) | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 6 (stage-2 steps) checks failed: {checks}")
    del state, probe, params
    torch.cuda.empty_cache()
    return threshold, records


def _masked_psnr(torch, params, cams):
    """PSNR of renders of ``cams`` against their images inside their
    masks (> 0.5), over all those pixels."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera,
                                                            render)
    se, n = 0.0, 0
    for cam in cams:
        with torch.no_grad():
            rgb = render(params, RenderCamera.from_camera(cam, DEVICE),
                         torch.zeros(3, device=DEVICE), device=DEVICE).rgb
        gt = torch.as_tensor(np.asarray(cam.image, np.float32),
                             device=DEVICE)
        sel = torch.as_tensor(np.asarray(cam.mask) > 0.5, device=DEVICE)
        se += float(((rgb.clamp(0, 1) - gt)[sel] ** 2).sum())
        n += int(sel.sum()) * 3
    return 10.0 * math.log10(n / max(se, 1e-12))


def phase_inpaint_rec(torch, card, s, threshold):
    """Main path 6: the inpaint_rec CLI (REC_ITERS steps on the 51
    cameras), counters zeroed before and read after: K1, K2 and K3
    launched once per step, the inpainted views' loss falls (first vs
    last 20 such steps), densify ran and wrote rows, no non-finite
    gradient, the PLY written and loaded, and the masked PSNR of the seq
    views inside the SAM masks above the initial state's by
    REC_PSNR_MARGIN; returns the launch counts."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.gs import gaussians, obb
    from multiview_inpaint_tpu_torch.gs import scene as scene_mod
    from multiview_inpaint_tpu_torch.pipelines import inpaint_rec

    out = os.path.join(s["work"], "output_rec", s["sid"])
    shutil.rmtree(out, ignore_errors=True)
    first, until, every = REC_DENSIFY
    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with RecProbe(torch) as probe:
        inpaint_rec.main([
            "-s", s["src"], "-m", out, "--scene_id", s["sid"], "--ctrl_id",
            "0", "--bg_model", s["model"], "--bg_iteration", "1",
            "--workspace", s["ws"], "--registry", s["registry"],
            "--resolution", "1", "--n_mode", "2", "--frames",
            str(SEQ_FRAMES), "--n_samples", str(REC_SAMPLES),
            "--iterations", str(REC_ITERS), "--save_iterations",
            str(REC_ITERS), "--densify_from_iter", str(first),
            "--densify_until_iter", str(until), "--densification_interval",
            str(every), "--densify_grad_threshold", repr(threshold),
            "--opacity_reset_interval", "100000", "--log_interval", "10",
            "--device", DEVICE])
        torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(_kernels.LAUNCHES)
    kinds = probe.by_kind()
    seq_loss, seq_ms = kinds.get(("full", ORBIT_H), ([], []))
    bg_h = next((h for mode, h in kinds if mode == "background"), 0)
    bg_loss, bg_ms = kinds.get(("background", bg_h), ([], []))
    with open(os.path.join(out, "ctrl_0", "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    steps = [r for r in log if "loss" in r]
    densified = [r for r in log if "wanted" in r]
    ply = os.path.join(out, "ctrl_0", "point_cloud",
                       f"iteration_{REC_ITERS}", "point_cloud.ply")
    final = gaussians.load_ply(ply, 0, device=DEVICE)
    sc = _rec_scene(s)
    seq_cams = scene_mod.inpaint_cameras(sc, n_mode=2, ctrl_id=0,
                                         frames=SEQ_FRAMES, iteration=1)
    init = scene_mod.load_sd_ply(
        os.path.join(s["model"], "point_cloud", "del", "point_cloud.ply"),
        obb.load_obb(s["box"]), n_samples=REC_SAMPLES, device=DEVICE)
    psnr0 = _masked_psnr(torch, init, seq_cams)
    psnr1 = _masked_psnr(torch, final, seq_cams)
    n = 20
    loss_first = statistics.mean(seq_loss[:n]) if seq_loss else 0.0
    loss_last = statistics.mean(seq_loss[-n:]) if seq_loss else 0.0
    checks = {
        "K1, K2, K3 once per step": launches == {
            "pair_expand": REC_ITERS, "composite": REC_ITERS,
            "composite_bwd": REC_ITERS, "flash_attn_fwd": 0,
            "flash_attn_bwd": 0},
        "every step probed": len(probe.steps) == REC_ITERS,
        "seq views' loss falls (first vs last 20)": loss_last < loss_first,
        f"densify ran at {list(range(first, until, every))}":
        [r["step"] for r in densified] == list(range(first, until, every)),
        "densify wrote rows": bool(densified) and sum(
            r["cloned"] + r["split"] for r in densified) > 0,
        "no non-finite gradient": all(r["nonfinite_grads"] == 0
                                      for r in steps),
        "PLY written and loaded": int(final.num_live()) > 0,
        f"masked PSNR up by > {REC_PSNR_MARGIN} dB":
        psnr1 > psnr0 + REC_PSNR_MARGIN,
    }
    densify = [{k: r[k] for k in ("step", "cloned", "split", "pruned",
                                  "wanted", "granted", "capacity")}
               for r in densified]
    print(f"[29 main inpaint_rec] inpaint_rec CLI, {REC_ITERS} steps on "
          f"{REC_CAMERAS} cameras per epoch (27 seq views at "
          f"{ORBIT_H}x{ORBIT_W}, 6 x {len(YAWS)} training views at "
          f"height {bg_h}) from load_sd_ply's rows in {cli_s:.2f} s | "
          f"launches {launches} | seq steps {len(seq_loss)}"
          f", loss first/last {n} {loss_first:.5f} -> {loss_last:.5f}; "
          f"background steps {len(bg_loss)} | median step ms (CUDA events) "
          f"seq full {statistics.median(seq_ms or [0]):.3f}, training view "
          f"background {statistics.median(bg_ms or [0]):.3f} | densify "
          f"{densify} | points {steps[-1]['points'] if steps else None} | "
          f"masked PSNR in the SAM masks {psnr0:.3f} -> {psnr1:.3f} dB | "
          f"peak device memory {peak_gb:.2f} GB | {json.dumps(checks)} | "
          f"{card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 6 (inpaint_rec CLI) checks failed: {checks}")
    return launches


def _write_ckpt(torch, path, modules):
    """``torch.save`` of ``{"state_dict": ...}`` with each module's state
    under its prefix (``modules``: (prefix, module) pairs), the tensors
    copied to the host; returns the seconds taken."""
    t0 = time.perf_counter()
    sd = {pre + k: v.detach().cpu() for pre, m in modules
          for k, v in m.state_dict().items()}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": sd}, path)
    return time.perf_counter() - t0


def _random_prior(torch, cfg, seed, controlnet=False):
    """A random full-width UNet2D (or ControlNet2D) on the card, every
    all-zero parameter moved."""
    from multiview_inpaint_tpu_torch.diffusion.controlnet2d import (
        ControlNet2D)
    from multiview_inpaint_tpu_torch.diffusion.unet2d import UNet2D

    torch.manual_seed(seed)
    net = (ControlNet2D if controlnet else UNet2D)(cfg, device=DEVICE)
    perturb_zero_params(torch, net, seed)
    return net


def _random_vae(torch, seed):
    from multiview_inpaint_tpu_torch.diffusion.vae import (AutoencoderKL,
                                                           VAEConfig)
    torch.manual_seed(seed)
    vae = AutoencoderKL(VAEConfig(), video_decoder=False, device=DEVICE)
    perturb_zero_params(torch, vae, seed)
    return vae


def _text_embs(dim, seed):
    """[2, 77, dim] f32 (unconditional, prompt) from the seed, shaped as a
    text tower's outputs for the empty prompt and a short one are: the
    same start and padding tokens, the prompt's TEXT_TOKENS tokens after
    the start token drawn anew. (Two independent draws differ at every
    token, far more than a prompt and the empty prompt do: at CFG 100
    that made the random prior's SDS term 20 times the background loss.)
    """
    rng = np.random.default_rng(seed)
    uc = rng.normal(size=(77, dim)).astype(np.float32)
    c = uc.copy()
    c[1:1 + TEXT_TOKENS] = rng.normal(size=(TEXT_TOKENS, dim))
    return np.stack([uc, c])


def phase_slice7_setup(torch, card, s):
    """Main path 7's weights: a random SD-2-inpainting-width UNet2D and 2D
    VAE written as one ``.ckpt`` (``torch.save``; the card's machine has
    no ``safetensors``), the text embeddings [2, 77, 1024] from the seed,
    and the SDS prior built from that file as ``sds_train`` builds it;
    returns them with the write and load seconds."""
    import argparse

    from multiview_inpaint_tpu_torch.diffusion import checkpoint
    from multiview_inpaint_tpu_torch.diffusion.unet2d import UNet2DConfig
    from multiview_inpaint_tpu_torch.pipelines import sds_train

    work = os.path.join(s["work"], "slice7")
    os.makedirs(work, exist_ok=True)
    sw = dict(work=work, sd=os.path.join(work, "sd2_inpaint.ckpt"),
              embs=os.path.join(work, "embs_1024.npy"))
    unet = _random_prior(torch, UNet2DConfig(), 70)
    vae = _random_vae(torch, 71)
    n_params = sum(p.numel() for m in (unet, vae) for p in m.parameters())
    write_s = _write_ckpt(torch, sw["sd"], (
        (checkpoint.PREFIXES["unet"], unet), (checkpoint.PREFIXES["vae"],
                                              vae)))
    del unet, vae
    torch.cuda.empty_cache()
    np.save(sw["embs"], _text_embs(1024, 72))
    t0 = time.perf_counter()
    sw["guidance"] = sds_train.build_guidance(argparse.Namespace(
        sd_ckpt=sw["sd"], guidance_scale=SDS_GUIDANCE), DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sw["text"] = torch.as_tensor(np.load(sw["embs"]), device=DEVICE)
    print(f"[30 slice-7 setup] SD-2-inpainting-width UNet2D (UNet2DConfig()) "
          f"+ 2D VAE: {n_params} random f32 parameters, all-zero ones moved,"
          f" written as {os.path.getsize(sw['sd']) / 2**30:.2f} GiB .ckpt in "
          f"{write_s:.2f} s, read into the SDS prior (build_guidance) in "
          f"{load_s:.2f} s | text embeddings [2, 77, 1024] from the seed "
          f"(the prompt's {TEXT_TOKENS} tokens apart) | "
          f"{card}", flush=True)
    return sw


def phase_unet2d_eval(torch, card, sw):
    """One CFG evaluation of the full-width UNet2D (batch 2 at a 64x64
    latent, t = 500), q and k projections scaled by SVD_QK_GAIN, through
    K4; with ``attention_op``'s K4 call patched to the plain version; to
    two planted faults (the first key tile dropped; an exp2 softmax
    without log2 e); through K4 from another input seed. The UNet is a
    second copy of the prior's weights (the scaling stays off the SDS
    prior)."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import (attention_op,
                                                       checkpoint,
                                                       flash_attention)
    from multiview_inpaint_tpu_torch.diffusion.transformer import (
        CrossAttention)
    from multiview_inpaint_tpu_torch.diffusion.unet2d import (UNet2D,
                                                              UNet2DConfig)

    unet = UNet2D(UNet2DConfig(), device=DEVICE)
    sd = checkpoint.read_state_dict(sw["sd"])
    missing, _ = checkpoint.import_state_dict(unet, sd,
                                              checkpoint.PREFIXES["unet"])
    del sd
    unet.eval().requires_grad_(False)
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, CrossAttention):
                m.to_q.weight.mul_(SVD_QK_GAIN)
                m.to_k.weight.mul_(SVD_QK_GAIN)
    real = attention_op.flash_attention
    ref = flash_attention.flash_attention_ref
    t = torch.full((2,), 500.0, device=DEVICE)

    def evaluate(seed, attend):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        x = torch.randn((2, SDS_LATENT, SDS_LATENT, 9), generator=gen,
                        device=DEVICE)
        attention_op.flash_attention = attend
        try:
            _kernels.reset_launches()
            with torch.no_grad():
                out = unet(x, t, sw["text"])
            torch.cuda.synchronize()
        finally:
            attention_op.flash_attention = real
        return out, _kernels.LAUNCHES["flash_attn_fwd"]

    out_k4, n_k4 = evaluate(31, real)
    out_plain, n_plain = evaluate(31, ref)
    out_drop, _ = evaluate(31, lambda q, k, v, h, sm: ref(
        q, k[:, FAULT_KEYS:], v[:, FAULT_KEYS:], h, sm))
    out_base, _ = evaluate(31, lambda q, k, v, h, sm: real(
        q, k, v, h, sm * math.log(2)))
    out_seed, _ = evaluate(32, real)
    err, drop, base = (_rms(o, out_plain) for o in (out_k4, out_drop,
                                                   out_base))
    seed_diff = _rms(out_seed, out_k4)
    bar = SVD_EVAL_RMS_TOL
    print(f"[31 unet2d eval] one CFG evaluation of the full-width UNet2D "
          f"(batch 2, {SDS_LATENT}x{SDS_LATENT} latent, t 500, q and k x"
          f"{SVD_QK_GAIN}, missing {len(missing)}): K4 launches {n_k4}, with "
          f"attention_op's K4 call patched to the plain version {n_plain} | "
          f"relative rms diff from the plain-attention eps: K4 {err:.4g} "
          f"(max abs {float((out_k4 - out_plain).abs().max()):.4g} of "
          f"max|plain| {float(out_plain.abs().max()):.4g}), bar {bar}; "
          f"planted faults: first key tile dropped {drop:.4g}, softmax base 2"
          f" {base:.4g} | another input seed moves it by {seed_diff:.4g} | "
          f"all finite: {bool(torch.isfinite(out_k4).all())} | {card}",
          flush=True)
    del unet
    torch.cuda.empty_cache()
    if not (n_k4 == K4_PER_UNET2D_EVAL and n_plain == 0 and not missing
            and err <= bar and bar < min(drop, base)
            and bar <= seed_diff / 10 and torch.isfinite(out_k4).all()):
        fail("the full-width UNet2D through K4 disagrees with the plain "
             "attention, or the bar does not separate the planted faults")


class SdsProbe:
    """Runs the real ``sds_trainer.sds_train_step`` and keeps what its
    checks need: the pair binning's gaussian ids, K1's and K3's inputs
    (as ``StepProbe`` keeps them), and the gradient the SDS term sends
    into the prior's input image (a hook on the image the prior's
    ``vae_encode`` takes with a gradient)."""

    def __init__(self, torch, guidance):
        from multiview_inpaint_tpu_torch.ops.rasterizer import (
            binning, composite_cuda)
        self.torch, self.k3_args, self.gid = torch, None, None
        self.k1_args, self.img_grad = None, None

        def bins(*a, **kw):
            b = bin_gaussians(*a, **kw)
            self.gid = b.order[b.gid_sorted]
            return b

        def k3(*a):
            self.k3_args = a
            return composite_bwd(*a)

        def k1(*a):
            self.k1_args = a
            return expand_keys(*a)

        def keep(g):
            self.img_grad = g.detach()

        def encode(img):
            if img.requires_grad:
                img.register_hook(keep)
            return vae_encode(img)

        bin_gaussians, expand_keys = binning.bin_gaussians, binning.expand_keys
        composite_bwd = composite_cuda.composite_bwd
        vae_encode = guidance.vae_encode
        self.patches = [(binning, "bin_gaussians", bins),
                        (binning, "expand_keys", k1),
                        (composite_cuda, "composite_bwd", k3),
                        (guidance, "vae_encode", encode)]

    def step(self, *args, **kw):
        """``sds_trainer.sds_train_step(*args, **kw)`` with the wrappers
        in place."""
        from multiview_inpaint_tpu_torch.models import sds_trainer
        saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for m, n, f in self.patches:
            setattr(m, n, f)
        try:
            out = sds_trainer.sds_train_step(*args, **kw)
            self.torch.cuda.synchronize()
        finally:
            for m, n, f in saved:
                setattr(m, n, f)
        return out


def sds_split(torch, state, args, kw):
    """Device ms (``cuda_ms``, mean of 3 after a warm-up) of one SDS step
    and of its parts run alone on the step's inputs: the render forward
    with the step's leaves, the VAE encode of a 512^2 image forward and
    forward + backward, the CFG UNet evaluation, Adam; ``rest`` is the
    step less those (the render backward, the background loss, the
    resizes, the masked encode)."""
    from multiview_inpaint_tpu_torch.diffusion.clip_vit import (
        resize_bilinear)
    from multiview_inpaint_tpu_torch.models import gs_trainer, sds_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import render

    cam, _, _, bg, cfg, guidance, text = args
    p = state.params
    fields, offset = gs_trainer.leaves(p)
    live = dataclasses.replace(p, **fields)

    def render_fwd():
        return render(live, cam, bg, means2d_offset=offset, device=DEVICE)

    out = render_fwd()
    x = resize_bilinear(out.rgb.detach().clamp(0, 1)[None],
                        (SDS_SIZE, SDS_SIZE)).requires_grad_(True)
    cot = torch.randn((1, SDS_LATENT, SDS_LATENT, 4), device=DEVICE)
    x9 = torch.randn((1, SDS_LATENT, SDS_LATENT, 9), device=DEVICE)
    t = torch.full((1,), 500.0, device=DEVICE)
    grads = {f: torch.randn_like(v) for f, v in fields.items()}

    def encode_fwd_bwd():
        torch.autograd.grad(guidance.vae_encode(x), x, cot)

    def cfg_unet():
        with torch.no_grad():
            return guidance._eps_cfg(x9, t, text)

    parts = {
        "step": cuda_ms(torch, lambda: sds_trainer.sds_train_step(
            state, *args, **kw), 3),
        "render_fwd": cuda_ms(torch, render_fwd, 3),
        "vae_encode_fwd": cuda_ms(torch, lambda: guidance.vae_encode(x), 3),
        "vae_encode_fwd_bwd": cuda_ms(torch, encode_fwd_bwd, 3),
        "cfg_unet": cuda_ms(torch, cfg_unet, 3),
        "adam": cuda_ms(torch, lambda: gs_trainer.apply_adam(
            state, grads, offset.detach(), out.radii, out.visibility, cfg,
            kw["spatial_lr_scale"]), 3),
    }
    parts["rest"] = parts["step"] - sum(
        v for k, v in parts.items() if k not in ("step", "vae_encode_fwd"))
    return parts


def _sds_scene(s):
    """Main path 7's SDS cameras (the bds_train views with their box
    masks) and the training rows (the del PLY + box samples)."""
    from multiview_inpaint_tpu_torch.gs import obb
    from multiview_inpaint_tpu_torch.gs import scene as scene_mod

    sc = _rec_scene(s)
    box = obb.load_obb(s["box"])
    cams = scene_mod.sds_cameras(sc, box, iteration=1)
    params = scene_mod.load_sd_ply(
        os.path.join(s["model"], "point_cloud", "del", "point_cloud.ply"),
        box, n_samples=REC_SAMPLES, device=DEVICE)
    return sc, cams, params


def phase_sds_step(torch, card, s, sw):
    """Main path 7: one SDS step at full width on a 1080p bds_train view
    after a warm-up step on it (``SdsProbe``): K3 against its plain
    version under the step's own cotangent (``check_k3``), K1 and K2
    against theirs with the per-item state (``k2_with_state``), the SDS
    image gradient finite and non-zero inside the mask, the launches of
    the step, its split and peak memory; returns the densification
    threshold and the kernels' records."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.guidance.sds import resize_nearest
    from multiview_inpaint_tpu_torch.models import gs_trainer, sds_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera

    sc, cams, params = _sds_scene(s)
    cam = cams[0]
    state = gs_trainer.init_state(params)
    gt = torch.as_tensor(np.asarray(cam.image, np.float32), device=DEVICE)
    mask = torch.as_tensor(np.asarray(cam.mask, np.float32), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(33)
    args = (RenderCamera.from_camera(cam, DEVICE), gt, mask,
            torch.zeros(3, device=DEVICE), gs_trainer.INPAINT_OPT,
            sw["guidance"], sw["text"])
    kw = dict(spatial_lr_scale=sc.cameras_extent, sds_weight=SDS_WEIGHT,
              sds_size=SDS_SIZE, generator=gen)
    state, _ = sds_trainer.sds_train_step(state, *args, **kw)   # warm-up
    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    probe = SdsProbe(torch, sw["guidance"])
    state, m = probe.step(state, *args, **kw)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(_kernels.LAUNCHES)
    g = probe.img_grad[0]
    inside = resize_nearest(mask, (SDS_SIZE, SDS_SIZE)) > 0.5
    g_in = g.abs().amax(dim=-1)[inside]
    label = f"32 sds step {cam.width}x{cam.height}"
    k3 = check_k3(torch, card, f"{label} K3", probe.k3_args, probe.gid,
                  state.params.capacity)
    k1, k2 = k2_with_state(torch, card, probe, "32", "orbit-sds 1080p")
    seen = state.stats.denom > 0
    threshold = float(torch.quantile(state.stats.grad_accum[seen][:2**24],
                                     REC_DENSIFY_QUANTILE))
    split = sds_split(torch, state, args, kw)
    checks = {
        f"{len(YAWS)} SDS cameras (bds_train views with box masks)":
        len(cams) == len(YAWS),
        "K1, K2, K3 once, K4 10 times, K5 never":
        launches == {"pair_expand": 1, "composite": 1, "composite_bwd": 1,
                     "flash_attn_fwd": K4_PER_UNET2D_EVAL,
                     "flash_attn_bwd": 0},
        "loss finite, no non-finite gradient": bool(
            torch.isfinite(m.loss)) and int(m.nonfinite_grads) == 0,
        "SDS image gradient finite": bool(torch.isfinite(g).all()),
        "SDS image gradient non-zero inside the mask": bool(
            (g_in > 0).float().mean() > 0.5),
    }
    print(f"[{label}] {int(params.num_live())} rows, pairs {m.pairs}, loss "
          f"{float(m.loss):.6g} (background {float(m.bg_loss):.6g}, SDS "
          f"{float(m.sds_loss):.6g} x {SDS_WEIGHT}) | launches {launches} | "
          f"SDS image gradient at {SDS_SIZE}^2: max|g| "
          f"{float(g.abs().max()):.4g}, share of mask pixels with g != 0 "
          f"{float((g_in > 0).float().mean()):.4f} | device ms (cuda_ms, "
          f"the parts run alone) "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})} | peak "
          f"device memory {peak_gb:.2f} GB "
          f"| densify threshold {threshold:.4g} (the {REC_DENSIFY_QUANTILE} "
          f"quantile) | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 7 (SDS step) checks failed: {checks}")
    del state, probe, params
    torch.cuda.empty_cache()
    return threshold, dict(K1=k1, K2=k2, K3=k3)


def phase_sds_train(torch, card, s, sw, threshold):
    """Main path 7: the sds_train CLI (SDS_ITERS steps on the SDS
    cameras, the prior from the .ckpt), counters zeroed before and read
    after: K1-K3 once and K4 10 times per step, K5 never; the background
    loss of the 20 steps before the densification at step 50 below the
    first 20's (the split right after it repaints the background for
    the next steps), finite after it; densify ran at step 50 and wrote
    rows; no non-finite gradient; the PLY written and loaded; median step
    ms and peak memory. Returns the launches and the model dir."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.gs import gaussians
    from multiview_inpaint_tpu_torch.models import sds_trainer
    from multiview_inpaint_tpu_torch.pipelines import sds_train

    out = os.path.join(s["work"], "output_sds", s["sid"])
    shutil.rmtree(out, ignore_errors=True)
    real, times = sds_trainer.sds_train_step, []

    def step(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = real(*a, **kw)
        end.record()
        times.append((start, end))
        return res

    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sds_trainer.sds_train_step = step
    t0 = time.perf_counter()
    try:
        sds_train.main([
            "-s", s["src"], "-m", out, "--scene_id", s["sid"],
            "--bg_model", s["model"], "--bg_iteration", "1", "--workspace",
            s["ws"], "--registry", s["registry"], "--resolution", "1",
            "--n_samples", str(REC_SAMPLES), "--iterations", str(SDS_ITERS),
            "--save_iterations", str(SDS_ITERS), "--sd_ckpt", sw["sd"],
            "--text_embs", sw["embs"], "--densify_grad_threshold",
            repr(threshold), "--log_interval", "1", "--device", DEVICE])
        torch.cuda.synchronize()
    finally:
        sds_trainer.sds_train_step = real
    cli_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(_kernels.LAUNCHES)
    ms = [a.elapsed_time(b) for a, b in times]
    with open(os.path.join(out, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    steps = [r for r in log if "bg" in r]
    densified = [r for r in log if "wanted" in r]
    ply = os.path.join(out, "point_cloud", f"iteration_{SDS_ITERS}",
                       "point_cloud.ply")
    final = gaussians.load_ply(ply, 0, device=DEVICE)
    bg = [r["bg"] for r in steps]
    n = 20
    checks = {
        "K1-K3 once, K4 10 times per step, K5 never": launches == {
            "pair_expand": SDS_ITERS, "composite": SDS_ITERS,
            "composite_bwd": SDS_ITERS,
            "flash_attn_fwd": K4_PER_UNET2D_EVAL * SDS_ITERS,
            "flash_attn_bwd": 0},
        "every step logged": len(steps) == SDS_ITERS == len(ms),
        f"background loss falls (steps 1-{n} vs the {n} before the "
        f"densification at {SDS_DENSIFY})": statistics.mean(
            bg[SDS_DENSIFY - n:SDS_DENSIFY]) < statistics.mean(bg[:n]),
        "background loss finite after it": all(
            math.isfinite(v) for v in bg[SDS_DENSIFY:]),
        f"densify ran at step {SDS_DENSIFY} and wrote rows": [
            r["step"] for r in densified] == [SDS_DENSIFY] and sum(
            r["cloned"] + r["split"] for r in densified) > 0,
        "no non-finite gradient": all(r["nonfinite_grads"] == 0
                                      for r in steps),
        "SDS loss finite": all(math.isfinite(r["sds"]) for r in steps),
        "PLY written and loaded": int(final.num_live()) > 0,
    }
    densify = [{k: r[k] for k in ("step", "cloned", "split", "pruned",
                                  "wanted", "granted", "capacity")}
               for r in densified]
    windows = [round(statistics.mean(bg[i:i + 10]), 6)
               for i in range(0, len(bg), 10)]
    print(f"[33 main sds_train] sds_train CLI, {SDS_ITERS} steps on the "
          f"{len(YAWS)} bds_train views at 1920x1080, SD-2-inpainting-width "
          f"prior from the .ckpt, in {cli_s:.2f} s | launches {launches} | "
          f"background loss steps 1-{n} {statistics.mean(bg[:n]):.6f}, "
          f"{SDS_DENSIFY - n + 1}-{SDS_DENSIFY} "
          f"{statistics.mean(bg[SDS_DENSIFY - n:SDS_DENSIFY]):.6f}, after "
          f"the densification {statistics.mean(bg[SDS_DENSIFY:]):.6f} (by "
          f"10 steps {windows}), SDS term median "
          f"{statistics.median(r['sds'] for r in steps) * SDS_WEIGHT:.5g} "
          f"(SDS loss x {SDS_WEIGHT}) | step ms (CUDA "
          f"events) median {statistics.median(ms):.3f}, first {ms[0]:.3f} | "
          f"densify {densify} | points {steps[-1]['points']} | peak device "
          f"memory {peak_gb:.2f} GB | {json.dumps(checks)} | {card}",
          flush=True)
    if not all(checks.values()):
        fail(f"main path 7 (sds_train CLI) checks failed: {checks}")
    return launches, out


def _png_stats(paths):
    arrs = [_png_array(p) for p in paths]
    return arrs, all(a.max() > a.min() for a in arrs)


def phase_sds_depth(torch, card, s, sds_out):
    """Main path 7: ``gen_seq --sds`` on the sds_train PLY; ``gen_depth
    --dpt_ckpt`` with a random DPT-large; ``gen_depth`` rendering the
    disparity, each PNG held against the plain K2 route's disparity on
    the card. Counters zeroed before each CLI; returns their launches."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.config import registries
    from multiview_inpaint_tpu_torch.gs import gaussians, obb
    from multiview_inpaint_tpu_torch.gs import scene as scene_mod
    from multiview_inpaint_tpu_torch.models import dpt
    from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera,
                                                            composite)
    from multiview_inpaint_tpu_torch.pipelines import gen_depth, gen_seq

    common = ["-s", s["src"], "--scene_id", s["sid"], "--workspace",
              s["ws"], "--registry", s["registry"], "--resolution", "1",
              "--device", DEVICE]
    n = len(SEQ_MODES) * SEQ_FRAMES
    launches, secs = {}, {}

    def run(name, main, argv):
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        main(argv)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches[name] = dict(_kernels.LAUNCHES)
        return torch.cuda.max_memory_allocated() / 2**30

    run("gen_seq --sds", gen_seq.main, common + [
        "-m", sds_out, "--iteration", str(SDS_ITERS), "--sds"])
    seq = os.path.join(s["ws"], "inpaint_sds", "seq", s["sid"])
    renders = [os.path.join(seq, m, f"ours_{SDS_ITERS}", "renders", f)
               for m in SEQ_MODES for f in sorted(os.listdir(os.path.join(
                   seq, m, f"ours_{SDS_ITERS}", "renders")))]
    _, seq_varied = _png_stats(renders)

    torch.manual_seed(73)
    model = dpt.DPTDepth(dpt.DPTConfig(), device=DEVICE)
    perturb_zero_params(torch, model, 73)
    dpt_path = os.path.join(s["work"], "slice7", "dpt_large.pth")
    t0 = time.perf_counter()
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               dpt_path)
    dpt_write_s = time.perf_counter() - t0
    del model
    depth_argv = common + ["-m", s["model"], "--sds_model", sds_out,
                           "--sds_iteration", str(SDS_ITERS)]
    real_estimate, dpt_ms = dpt.estimate_depth, []

    def estimate(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = real_estimate(*a, **kw)
        end.record()
        dpt_ms.append((start, end))
        return res

    dpt.estimate_depth = estimate
    try:
        dpt_peak = run("gen_depth --dpt_ckpt", gen_depth.main, depth_argv
                       + ["--dpt_ckpt", dpt_path])
    finally:
        dpt.estimate_depth = real_estimate
    dpt_ms = [a.elapsed_time(b) for a, b in dpt_ms]
    depth_dir = os.path.join(s["ws"], "inpaint", "depth", s["sid"])
    names = [(m, f) for m in SEQ_MODES
             for f in sorted(os.listdir(os.path.join(depth_dir, m)))]
    _, dpt_varied = _png_stats(os.path.join(depth_dir, m, f)
                               for m, f in names)
    run("gen_depth", gen_depth.main, depth_argv)

    # The written disparity against the plain K2 route's, frame by frame.
    registries.load_registry_overrides(s["registry"])
    sc = scene_mod.Scene(s["src"], s["model"], resolution=1, shuffle=False,
                         load_gaussians=False)
    sc.scene_name = s["sid"]
    o = registries.get_orbit_params(STAGE1_SCENE)
    params = gaussians.load_ply(os.path.join(
        sds_out, "point_cloud", f"iteration_{SDS_ITERS}", "point_cloud.ply"),
        0, device=DEVICE)
    box = obb.load_obb(s["box"])
    differ, worst, frames = 0, 0, 0
    for mode in SEQ_MODES:
        for view in scene_mod.orbit_cameras(
                sc.front_view(), box, mode=mode, frames=SEQ_FRAMES,
                view_range=o.view_range, r_scale=o.r_scale, k_lift=o.k_lift,
                k_bias=o.k_bias):
            out = _render_route(torch, params, RenderCamera.from_camera(
                view, DEVICE), lambda *a: composite.composite_segments(*a))
            disp = gen_depth.disparity(out.depth.cpu().numpy())
            want = (np.clip(disp, 0, 1) * 255).astype(np.uint8)
            got = _png_array(os.path.join(depth_dir, mode,
                                          f"{view.image_name}.png"))
            d = np.abs(got[..., 0].astype(int) - want.astype(int))
            differ += int((d > 0).sum())
            worst = max(worst, int(d.max()))
            frames += 1
    pixels = frames * ORBIT_H * ORBIT_W
    checks = {
        "DPT run on every frame": len(dpt_ms) == n,
        f"gen_seq --sds: K1, K2 {n} times": launches["gen_seq --sds"]
        == _forward_launches(n),
        "gen_seq --sds renders not constant": seq_varied,
        f"gen_depth --dpt_ckpt: K1, K2 {n} times": launches[
            "gen_depth --dpt_ckpt"] == _forward_launches(n),
        "DPT depth PNGs not constant": dpt_varied,
        f"gen_depth: K1, K2 {n} times": launches["gen_depth"]
        == _forward_launches(n),
        f"disparity equal to the plain K2 route's on all but "
        f"{BAD_FRACTION} of pixels, by at most 1 level": frames == n and (
            differ <= BAD_FRACTION * pixels and worst <= 1),
    }
    print(f"[34 main gen_seq --sds, gen_depth] gen_seq --sds on the "
          f"sds_train PLY ({int(params.num_live())} rows) "
          f"{secs['gen_seq --sds']:.2f} s; "
          f"gen_depth --dpt_ckpt (random DPT-large, DPTConfig(), "
          f"{os.path.getsize(dpt_path) / 2**30:.2f} GiB written in "
          f"{dpt_write_s:.2f} s) {secs['gen_depth --dpt_ckpt']:.2f} s for "
          f"{n} frames with the load, DPT ms per frame (CUDA events, "
          f"estimate_depth) median {statistics.median(dpt_ms or [0]):.2f}, "
          f"peak {dpt_peak:.2f} GB; gen_depth "
          f"(rendered disparity) {secs['gen_depth']:.2f} s | disparity vs "
          f"the plain K2 route: {differ} of {pixels} pixels differ, by at "
          f"most {worst} | launches {json.dumps(launches)} | "
          f"{json.dumps(checks)} | {card}", flush=True)
    os.remove(dpt_path)
    if not all(checks.values()):
        fail(f"main path 7 (gen_seq --sds, gen_depth) checks failed: "
             f"{checks}")
    return launches


def phase_ctrl_inpaint(torch, card, s, sw):
    """Main path 7: ``ctrl_inpaint`` at full width (``--context_dim 768``,
    ``--size 512``) from random SD-1.5-size UNet2D + VAE and ControlNet2D
    checkpoints: 2 samples of 10 UniPC steps, then 1 of DPM++(2M), the
    counters zeroed before each run: K4 14 times per evaluation, no other
    kernel; seconds per sample (CUDA events around the sampler), peak
    memory; the PNGs written and not constant."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import checkpoint, samplers
    from multiview_inpaint_tpu_torch.diffusion.unet2d import UNet2DConfig
    from multiview_inpaint_tpu_torch.pipelines import ctrl_inpaint

    cfg = UNet2DConfig(context_dim=CTRL_CONTEXT)
    paths = dict(sd=os.path.join(sw["work"], "sd15_inpaint.ckpt"),
                 ctrl=os.path.join(sw["work"], "control_depth.ckpt"),
                 embs=os.path.join(sw["work"], "embs_768.npy"))
    unet = _random_prior(torch, cfg, 74)
    vae = _random_vae(torch, 75)
    write_s = _write_ckpt(torch, paths["sd"], (
        (checkpoint.PREFIXES["unet"], unet), (checkpoint.PREFIXES["vae"],
                                              vae)))
    del unet, vae
    cnet = _random_prior(torch, cfg, 76, controlnet=True)
    write_s += _write_ckpt(torch, paths["ctrl"], (
        (checkpoint.PREFIXES["controlnet"], cnet),))
    del cnet
    torch.cuda.empty_cache()
    np.save(paths["embs"], _text_embs(CTRL_CONTEXT, 77))
    out_dir = os.path.join(s["ws"], "inpaint", "ctrl", s["sid"])
    runs = {}
    for sampler, n_samples in (("unipc", 2), ("dpmpp2m", 1)):
        shutil.rmtree(out_dir, ignore_errors=True)
        real = getattr(samplers, f"{sampler}_sample")
        times = []

        def timed(*a, real=real, times=times, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = real(*a, **kw)
            end.record()
            times.append((start, end))
            return res

        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        setattr(samplers, f"{sampler}_sample", timed)
        t0 = time.perf_counter()
        try:
            ctrl_inpaint.main([
                "--scene_id", s["sid"], "--workspace", s["ws"],
                "--sd_ckpt", paths["sd"], "--ctrl_ckpt", paths["ctrl"],
                "--text_embs", paths["embs"], "--context_dim",
                str(CTRL_CONTEXT), "--size", str(SDS_SIZE), "--iteration",
                "1", "--n_samples", str(n_samples), "--num_steps",
                str(CTRL_STEPS), "--sampler", sampler, "--device", DEVICE])
            torch.cuda.synchronize()
        finally:
            setattr(samplers, f"{sampler}_sample", real)
        cli_s = time.perf_counter() - t0
        pngs = [os.path.join(out_dir, f"ctrl_{i}.png")
                for i in range(n_samples)]
        arrs, varied = _png_stats(pngs)
        runs[sampler] = dict(
            launches=dict(_kernels.LAUNCHES), cli_s=cli_s,
            sample_s=[a.elapsed_time(b) / 1e3 for a, b in times],
            peak_gb=torch.cuda.max_memory_allocated() / 2**30,
            ok=(sorted(os.listdir(out_dir)) == [os.path.basename(p)
                                                for p in pngs]
                and varied and all(a.shape == (SDS_SIZE, SDS_SIZE, 3)
                                   for a in arrs)),
            n=n_samples)
    for p in paths.values():
        os.remove(p)
    checks = {}
    for sampler, r in runs.items():
        k4 = K4_PER_CTRL_EVAL * CTRL_STEPS * r["n"]
        checks[f"{sampler}: K4 {k4} times ({K4_PER_CTRL_EVAL} per "
               f"evaluation), no other kernel"] = r["launches"] == {
            "pair_expand": 0, "composite": 0, "composite_bwd": 0,
            "flash_attn_fwd": k4, "flash_attn_bwd": 0}
        checks[f"{sampler}: {r['n']} PNGs at {SDS_SIZE}^2, not constant"] = \
            r["ok"]
    print(f"[35 main ctrl_inpaint] ctrl_inpaint CLI at full width "
          f"(UNet2DConfig(context_dim={CTRL_CONTEXT}) + ControlNet2D + 2D "
          f"VAE, "
          f"random, all-zero parameters moved; checkpoints written in "
          f"{write_s:.2f} s), --size {SDS_SIZE}, {CTRL_STEPS} steps, CFG "
          f"batch 2 | "
          + " | ".join(
              f"{k}: {r['n']} samples in {r['cli_s']:.2f} s with the loads, "
              f"s per sample (sampler, CUDA events) "
              f"{[round(t, 3) for t in r['sample_s']]}, peak "
              f"{r['peak_gb']:.2f} GB, launches {r['launches']}"
              for k, r in runs.items())
          + f" | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 7 (ctrl_inpaint CLI) checks failed: {checks}")
    return {k: r["launches"] for k, r in runs.items()}


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
    k4 = phase_k4(torch, card)[0]
    phase_svd_engine(torch)
    launches_svd, probe = phase_svd_main(torch, card)
    phase_svd_eval(torch, card, probe)
    del probe   # main path 3's engine
    torch.cuda.empty_cache()
    k5 = phase_k5(torch, card)
    phase_k5_grad(torch, card)
    phase_svd_train_step(torch)
    launches_svd_train = phase_svd_train(torch, card)
    stage1 = phase_stage1_setup(card)
    phase_gen_seq(torch, card, stage1)
    phase_mask_plain(torch, card, stage1)
    phase_stage1_clis(torch, card, stage1)
    phase_delete_gen_pc(torch, card, stage1)
    visible, fov = phase_stage2_frames(torch, card, stage1)
    phase_seg_auto(torch, card, stage1, visible, fov)
    phase_seg_ground(torch, card, stage1)
    threshold, rec = phase_stage2_step(torch, card, stage1)
    launches_rec = phase_inpaint_rec(torch, card, stage1, threshold)
    sw = phase_slice7_setup(torch, card, stage1)
    k4_2d = phase_k4(torch, card, K4_2D_SHAPES, "30")
    phase_unet2d_eval(torch, card, sw)
    threshold7, sds = phase_sds_step(torch, card, stage1, sw)
    del sw["guidance"]
    torch.cuda.empty_cache()
    launches_sds, sds_out = phase_sds_train(torch, card, stage1, sw,
                                            threshold7)
    launches7 = [launches_sds, *phase_sds_depth(
        torch, card, stage1, sds_out).values(), *phase_ctrl_inpaint(
        torch, card, stage1, sw).values()]
    os.remove(sw["sd"])

    def path6(name, key):
        """Main path 6's launches and its orbit-rec times of one kernel."""
        return dict(launches=launches_rec[name],
                    orbit_rec={kind: r[key] for kind, r in rec.items()})

    def path7(name, key=None):
        """Main path 7's launches (every CLI's) and its times of one
        kernel: K1-K3 at the SDS step's 1080p view, K4 at the UNet2D's
        ds1 and ds2 shapes."""
        out = dict(launches=sum(n[name] for n in launches7))
        if key is None:
            return dict(out, unet2d_ds1=k4_2d[0], unet2d_ds2=k4_2d[1])
        return dict(out, orbit_sds=sds[key])

    k1, k2 = frames["big2m"]   # the render main path's scene and shapes
    kernels = [
        dict(name="pair_expand", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/pair_expand.cu",
             replaces="multiview_inpaint_tpu/ops/rasterizer/"
                      "pair_expand.py:92",
             launches=launches["pair_expand"], **k1,
             main_path_6=path6("pair_expand", "K1"),
             main_path_7=path7("pair_expand", "K1")),
        dict(name="composite", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/composite.cu",
             replaces="multiview_inpaint_tpu/ops/rasterizer/"
                      "pallas_composite.py:75",
             launches=launches["composite"], **k2,
             main_path_6=path6("composite", "K2"),
             main_path_7=path7("composite", "K2")),
        # K3 at the first step of main path 2, the path that runs it.
        dict(name="composite_bwd", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/composite_bwd.cu",
             replaces="multiview_inpaint_tpu/ops/rasterizer/"
                      "pallas_backward.py:54",
             launches=launches_train["composite_bwd"], **k3,
             main_path_6=path6("composite_bwd", "K3"),
             main_path_7=path7("composite_bwd", "K3")),
        # K4 at the ds1 shape of main path 3, the path that runs it.
        dict(name="flash_attn_fwd", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/flash_attn_fwd.cu",
             replaces="multiview_inpaint_tpu/diffusion/"
                      "flash_attention.py:55",
             launches=launches_svd["flash_attn_fwd"], **k4,
             main_path_7=path7("flash_attn_fwd")),
        # K5 at the ds1 shape of main path 4, the path that runs it; one
        # launch is the dk/dv kernel and the dq kernel back to back.
        dict(name="flash_attn_bwd", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/flash_attn_bwd.cu",
             replaces="multiview_inpaint_tpu/diffusion/"
                      "flash_attention.py:117",
             launches=launches_svd_train["flash_attn_bwd"], **k5),
    ]
    print(f"[36 done] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
