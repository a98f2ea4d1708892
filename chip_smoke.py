#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Drives ``multiview_inpaint_tpu_torch`` only (never JAX, never the JAX
package), phase by phase, one line each; any failure raises and exits
non-zero. It checks the port; it times nothing of it but each kernel
alone at its headline shape (the kernels line). Times of the port come
from ``port_bench/run.py --workload <cell> --trace 1`` and from the
spans (``--profile_dir`` on ``train_gs``, ``svd_test``, ``sds_train``);
where a phase runs the program under ``spans`` it prints each span's
count and device ms on one line. Inputs for a check are taken from a
real call with ``capture``; ``patched`` puts a planted fault, or the
plain version in a kernel's place:

1. the card (``nvidia-smi`` name and power limit), torch, TF32 settings
   (both TF32 switches are set off, so the plain versions run in fp32;
   phase 7 puts them back to PyTorch's defaults for its own checks);
2. build the CUDA kernels from ``multiview_inpaint_tpu_torch/csrc``, and
   print each flash kernel's registers, spills (ptxas) and dynamic shared
   memory, and any ptxas warning or performance note about them, K2's,
   K3's, K6's and K7's registers, spills and static shared memory (ptxas),
   K2's blocks per SM, and K3's blocks per SM and splats per warp
   reduction;
3. K1 (pair keys) against its plain version, bit for bit, on the inputs
   of one ``render`` of the 1080p bench frame of the 100k bench ball and
   of the 2M-gaussian scene (equal keys give equal segments: both go
   through the same sort);
4. K2 (composite) against its plain version on that render's K2 inputs:
   max errors, pixels beyond rgb 3e-5 / depth 3e-4 (at most 0.01%), every
   pixel within the stop-flip bound; its tiles bit-equal with and without
   the per-item state output, and that state against the plain K2's at
   the same bars over every item-pixel (``compare_state``); on the 2M
   frame, a planted fault (``k2_fault``: every gate box pulled in by one
   pixel) that the same bar must fail;
5. K3 (composite backward), started from K2's per-item state, against
   its plain version walking each tile from its start and against its
   plain version from the same state, on the same frames under a
   seeded cotangent (``check_k3``, which also prints the tile depths and
   the work items): max error per row, pairs beyond 2e-6 + 1e-4
   max|row| (at most 0.01%), the same for the per-gaussian gradients
   after the gather's backward, every pair and gaussian within the flip
   allowance, rows 10-15 exactly 0, bit-equal on a second run; on the 2M
   frame K1 and K2 timed beside their bounds;
5b. K6 (the gradient-free projection) on the 2M-gaussian scene in the
    1080p bench view against its plain version on the card, at SH degree
    0 (main path 1's params and degree) and at degree 3 (the same with
    seeded rest coefficients): radius, extent and visibility equal on
    every row, means2d zero on culled rows, every float within 1e-6
    relative; timed beside its bytes bound (109 and 289 B a splat);
5c. K7 (the projection's backward) on that scene and view at SH degree
    3, its cotangents columns of one packed [N, 16] gradient, against
    its plain version on the card: culled rows 0, NaN where the plain
    version has NaN, every finite gradient within 1e-5 of its field's
    largest; timed beside its bytes bound (524 B a splat);
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
   that scene and the 100k bench ball, every view finite and not
   constant;
10. main path 2 on an 8-view 960x540 orbit scene rendered from the
    2M-gaussian scene, from 200,000 of its points: first one
    ``train_step`` of that scene, whose K3 call (the real L1+SSIM
    cotangent) is held against the plain K3 as in phase 5, timed beside
    its bound, and sets the densification threshold (a quantile of that
    step's screen-space gradient norms), K1 on its inputs (bit-equal
    keys), and K2 on its inputs with and without the per-item state
    (tiles and state bit-equal to the step's, the state against the
    plain K2's as in phase 4); then the ``train_gs`` CLI for 60
    iterations in a buffer a little larger than the init, counters zeroed
    before and read after: loss falls, densify ran twice and wrote rows,
    the capacity grew, PLY and npz written, no non-finite gradient, K3
    and K7 launched once per step, K6 once per step and per evaluation
    render;
11. the train step at full width: the 2M-gaussian bench ball in a
    2,097,152-row buffer at 512x384, 12 steps with a
    finite loss and gradients, the last one's K3 call held against the
    plain K3 as in phase 5; then a planted fault (``k3_fault``: K3 fed
    the next item's state for the first item of the deepest tile) that
    the same bar must fail;
12. K4 (flash-attention forward) against its plain version as main path
    3 calls it, on the packed [B, T, H*D] projections: [28, 3072, 5*64]
    with 5 heads (ds1) and [28, 768, 10*64] with 10 heads (ds2) in bf16,
    and [2, 768, 64] in f32: max abs error (0.02) and relative to
    max|plain| (0.02), bit-equal on a second run and equal to K4 on the
    folded [B*H, T, D] layout; ds1 and ds2 timed beside their bound and
    beside ``scaled_dot_product_attention`` at the same shapes;
13. the tiny SVD engine (``svd_test --tiny_model``, 3 frames at 64x48)
    on CUDA against the CPU with the same weights (every all-zero
    parameter moved) and noise, f32 with TF32 off: conditioning, one
    guided denoiser evaluation, a 2-step sample (bounded by the f32
    spacing at its first step's start) and the decoding of one set of
    latents on both;
14. main path 3: the ``svd_test`` CLI at full width (VideoUNet 320,
    ControlNet, VAE, ViT-H CLIP: 2.9B random bf16 parameters made on the
    card, every all-zero one moved) on a synthetic gs/ tree, 14 frames at
    512x384, 25 Euler-EDM steps at CFG batch 28, under the spans: 14
    finite frames written, K4 launched exactly 350 times, 25 denoiser
    evaluations (``engine.eval`` spans);
15. one full-width guided denoiser evaluation at sigma_max, its q and k
    projections scaled so that the attention is far from uniform, through
    K4, then with ``attention_op``'s K4 call patched to the plain version
    (0 launches), against a bf16 bar that lies below what two planted K4
    faults (a dropped key tile, a softmax in the wrong exponent base)
    move (relative rms of the difference) and at most a tenth of what a
    change of noise seed moves;
15s. main path 12 (slice 11) on main path 3's engine: NCCL at world size
    1 (tcp on localhost); one ``frame_sharded_apply_model`` of the CFG
    batch of 28 rows against ``engine.apply_model`` (relative rms), its
    all-to-alls and all-gathers counted with their bytes; the same in f32
    (the engine cast to f32 at the end, the plain f32 attention in place
    of K4, which rounds p to bf16), and with two planted faults (the
    frame index shifted by one, the other video's context), each of which
    must fail the bf16 or the f32 bar; a 25-step clip through
    ``make_frame_sharded_denoiser`` against ``engine.sample`` from the
    same noise (the final latents' relative rms), K4 launched 350 times;
15t. once main path 3's engine is freed, the ``svd_test`` CLI with
    ``--shard_frames`` in one process on main path 3's tree and weights:
    the "ignored" line, main path 3's 14 frames within 1 uint8 level, K4
    350;
15a. main path 10 (slice 9a) begins once main path 3's engine is freed:
    the tiny SVD engine on CUDA against the CPU with phase 13's weights,
    noise and bars, the same draws injected on both: ``sample_blended``
    and ``sample_inversion`` (2 steps; the inversion's bar at the top
    inverted latent's magnitude), the ``SamplingPipeline`` with Heun,
    Euler ancestral, DPM++(2S) ancestral and LMS (3 steps), and the latent
    dump of a blended sample (files, sigma ladder, last latent = result);
15b. the ``svd_test`` CLI with ``--sampling blended --dump_latents`` at
    main path 3's width and shapes: 14 finite frames, K4
    launched exactly 350 times, 25 resampling evaluations, 25 dumps whose
    sigmas are the run's sigma_hat ladder, the last dump the sampled
    latents; the background check (outside the latent mask the last
    dumped latent within ``background_bar`` of the encoded background, a
    bar derived from the last step's arithmetic at sigma 0.002 and
    printed beside the reading; inside, a mean change 10 times the bar)
    and two planted faults that must fail it (the blend skipped, its mask
    inverted);
15c. the same CLI with ``--sampling inversion``: 14 finite frames, K4
    launched exactly 700 times (25 inversion and 25 resampling
    evaluations at batch 14), the background check with its bar for the
    inverted latents and the same planted faults;
15d. phase 12's checks of K4 at main path 10's new shapes: [14, 3072,
    5*64] and [14, 768, 10*64] in bf16 (the inversion's batch) and [28,
    3072, 5*64] in f32 (the demo's uncontrolled UNet);
15e. the ``divide_test`` CLI on the grids of 15b and 15c: its frames equal
    the CLI's per-frame PNGs byte for byte, GIF previews of 13 frames;
15f. the ``demo_app`` server (``make_server`` on port 0 in a thread,
    ``--device cuda``, the full-width engine initialised at the first
    request, its UNet in f32 on bf16-rounded weights): /health, the page,
    two POST /generate requests with a seeded 512x384 PNG (the defaults:
    25 steps, 14 frames; another seed at 10 steps) answered with 200 and
    14-frame GIFs that differ, the engine initialised once, K4 launched
    10 x steps times per request and no other kernel, a num_frames=3
    request answered with 500; then one f32 uncontrolled denoiser
    evaluation through K4 against the plain attention under phase 15's
    discipline (``DEMO_EVAL_RMS_TOL``);
16. K5 (flash-attention backward) against its plain version as main path
    4 calls it, on the packed projections of one video, [14, 3072, 5*64]
    (ds1) and [14, 768, 10*64] (ds2) bf16, and [2, 768, 64] f32, with o and
    the logsumexp from K4 and a seeded cotangent: dq, dk, dv within 0.02
    of max|plain| and 0.01 relative rms, bit-equal on a second run; ds1
    and ds2 timed beside their bound and beside the backward of
    ``scaled_dot_product_attention`` at the same shapes;
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
    for a few steps on a ``write_est_tree`` tree, under the spans: one
    step per scene (``engine.eval`` spans), K5 and K4 launched exactly 10
    and 14 times per step, finite losses, the UNet, VAE and CLIP
    bit-unchanged and the ControlNet moved, the EMA (the dict that
    ``ema_update`` updates) updated once a step, the checkpoint written
    and read back equal to it bit for bit;
19a. main path 12 (c) on main path 4's engine: two ``make_dp_train_step``
    steps with the EMA over NCCL at world size 1 against two
    ``make_train_step`` steps with the same draws from the same
    parameters: the losses within 1e-6 relative, the parameters and the
    EMA within one spacing of their type where |g| >= 1e-6; the flat
    all-reduce buffers' bytes, K5 20 and K4 28 launches;
20. main path 5's workspace (stage 1): the bench COLMAP scene of phase 9,
    the 2M-gaussian PLY, a ``--registry`` JSON (front view view00, the
    bicycle scene's orbit and vis parameters), an insertion box at the
    front of the foreground clusters near the origin and a deletion box
    inside the scene;
21. main path 5: the ``gen_seq`` CLI (14 frames x modes x1, x2 at
    512x384 and the 4 ``bds_train`` views at 1920x1080) under the spans:
    K1 and K2 launched exactly 32 times each and K3-K5 never, 32
    ``render`` spans, 14 renders/mask/masked PNGs per mode at 512x384,
    ``poses.npy`` (14, 4, 4), ``cam_center.npy`` at the box centre, 4
    ``bds_train`` masks at 1080p, each mode's masks non-empty in a frame
    and not all ones in all;
22. the ``gen_seq`` mask of frame 0 of x1 and of the front view at 1080p
    (and of the front view with the foreground clusters alone, which has
    empty pixels) through K1/K2 against the plain K2's route on the card:
    equal counts of pixels at the 15.0 sentinel, masks that differ only
    where t lies between the two depths within K2's stop-flip bound, the
    box hit on CUDA against the CPU except on rays within 1e-6 of a
    triangle edge (counted), the share of the box the scene hides in the
    front view (in (0, 1)); a planted fault (K2's empty pixels at a final
    T of 1 - 2^-24) that the sentinel check must fail; then phases 3-5's
    checks of K1-K3 at frame 0 of x1 (512x384);
23. the ``render_depth`` CLI (28 frames) and the ``vis_render --src`` CLI
    (55 frames) on the same scene, counters zeroed before each: K1 and K2
    launched exactly 28 and 55 times, no constant PNG;
24. the ``delete`` CLI on the 2M-gaussian PLY with the deletion box: some
    rows removed, none left inside by ``contains``, ``contains`` on CUDA
    against the CPU except on rows within 1e-6 of a face (counted); the
    ``gen_pc`` CLI writes 10,000 points;
25. main path 6 (stage 2) on main path 5's workspace: stand-ins for the
    ``svd_test`` frames, big2m and a 20,000-splat object of one saturated
    colour inside the insertion box rendered together (K1/K2) at the 28
    orbit poses and written as ctrl 0's inpainted PNGs, with each frame's
    visible-object mask (the object's alpha > 0.5 where it lies nearer
    than big2m);
26. the ``seg_masks`` CLI with ``--auto --propagate`` on modes x1 and x2:
    IoU of every frame's mask against the visible-object mask, median
    above 0.6 (the JAX test's bar), the worst frame, the box mask's own
    IoU beside it;
27. ``seg_masks --ground`` at full width on mode x1: random ViT-H/14 and
    23-layer text towers (every all-zero parameter moved, q and k x3)
    written as a JAX-layout f32 npz, a merges file the script writes and
    a plain-text query; every grounded mask within the same frame's
    ``--auto`` mask; the 57 window scores of frame 0 against the same
    towers in float64 on the card at 4 windows (bar 5e-3 of the largest
    float64 score);
28. one stage-2 step of each kind on ``load_sd_ply``'s 1,909,232 rows:
    a 512x384 seq view with the full loss and a 1080p
    training view with the background loss (a cotangent exactly 0 inside
    the box): K3 against its plain version as in phase 5 (``check_k3``),
    K1 and K2 against theirs with the per-item state
    (``k2_with_state``), the pairs whose K3 rows are all zero; the 51
    cameras per epoch; the densification threshold (a quantile of the
    seq step's screen-space gradients);
29. the ``inpaint_rec`` CLI, 400 steps with densification at steps 50,
    100 and 150, counters zeroed before and read after: K1, K2, K3, K6
    and K7 launched once per step, every step's loss captured, the
    inpainted views' loss falls (first vs last 20 of them), densify wrote
    rows, no non-finite gradient, the PLY written and loaded, the masked
    PSNR of the seq views inside the SAM masks above the initial state's
    by 1 dB;
30. main path 7 (slice 7) on main path 5's workspace: a random
    SD-2-inpainting-width UNet2D and 2D VAE (every all-zero parameter
    moved) written as a ``.ckpt`` and read into the SDS prior as
    ``sds_train`` builds it, text embeddings [2, 77, 1024] from the seed;
    then phase 12's checks of K4 at the UNet2D's CFG shapes, [2, 4096,
    5*64] (ds1) and [2, 1024, 10*64] (ds2) in f32;
31. one CFG evaluation of that UNet2D (q and k x3, as phase 15) through
    K4 against the same UNet with the plain attention (10 K4 launches,
    relative rms of the eps at phase 15's bar), two planted K4 faults
    that must exceed the bar, and another input seed;
32. one SDS step at full width on a 1080p bds_train view of the del PLY +
    30,000 box samples after a warm-up step: K3 against
    its plain version under the step's own cotangent (the background
    loss's plus the SDS gradient through the VAE encoder and the 1080p ->
    512^2 resize), K1 and K2 with the per-item state against theirs,
    K1-K3, K6 and K7 once, K4 10 times and K5 never, the SDS image
    gradient finite and non-zero inside the mask; the densification
    threshold (a quantile of this step's gradients);
33. the ``sds_train`` CLI with the ``.ckpt`` and the embeddings, 60 steps
    on the 4 bds_train views, densifying at step 50, under the spans:
    K1-K3, K6 and K7 once and K4 10 times per step, K5 never, every step
    logged and run (``sds.step`` spans), the background loss of the 20
    steps before the densification below the first 20's and finite
    after it, no non-finite gradient, the PLY written and loaded;
34. ``gen_seq --sds`` on that PLY, ``gen_depth --dpt_ckpt`` with a random
    DPT-large (run on every frame) and ``gen_depth`` rendering the
    disparity, counters zeroed before each (K1 and K2 28 times each); the
    written disparity against the plain K2 route's on every frame (all
    but 0.01% of pixels equal, none off by more than 1 level);
35. the ``ctrl_inpaint`` CLI at full width (``--context_dim 768``,
    ``--size 512``) from random SD-1.5-size UNet2D + VAE and ControlNet2D
    ``.ckpt`` files: 2 samples of 10 UniPC steps, then 1 of DPM++(2M):
    K4 14 times per evaluation and no other kernel, the PNGs not
    constant;
36. main path 8 (slice 8, evaluation) on main paths 5 and 6's workspace:
    the ``render`` CLI on main path 6's recomposed PLY and on main path
    5's source PLY at 10 bench views (1920x1080), counters zeroed before
    each run (K1 and K2 once per view, K3-K5 never), the frames moved into
    ``vis/cmp/<exp>/{inpainted,src}/<scene>/ours_<iter>/renders``; phases
    3-5's checks of K1-K3 at the recomposed PLY's first view;
37. the ``cmp`` CLI (``--n_frame 10``) on that tree with random full-width
    MUSIQ (2,153 tokens per frame) and WaDIQaM-NR npz files, counters
    zeroed before (no launches): sharpness, musiq, wadiqam and
    psnr_vs_src finite for the scene and in ``mean``; MUSIQ and WaDIQaM on
    one 1080p frame and LPIPS at full VGG16 on a [4, 512, 512, 3] pair on
    the card within 1e-4 relative of the CPU;
38. one ``vae_finetune --tiny`` step (every term on, LPIPS included) on
    CUDA against the CPU from the same weights and noise: logs within
    1e-5 relative, gradients at the gradient bar (plus 2e-7 of the
    network's largest), parameters within 2e-6 + 1e-4 max|update| or
    Adam's sign-flip allowance;
39. main path 9 (slice 9b): the ``vae_finetune`` CLI at full width
    (``VAEConfig()``, the ndf-64 3-layer discriminator, a random full VGG16
    LPIPS npz) on main path 5's 28 gen_seq frames at 256^2, batch 4, 20
    steps, ``--disc_start 5``, counters zeroed before (no launches): every
    step's log finite, ``loss/disc`` 0 before step 5 and not after, both
    npz files read back equal;
41. main path 11 (slice 10): main path 1's big2m 1080p bench frame as 4
    interleaved tile-row bands (``render(band_rows=, band_row0=,
    band_stride=)``) one after another, counters zeroed before (K1 and K2
    once per band): stitched bit for bit equal to the full frame, the
    pairs summed equal; the heaviest band's K2 call against its plain
    version (phase 4's bars) and bit-equal to the full frame's K2 call on
    the same tiles;
42. main path 2's ball2m-train step as 4 bands on the card
    (``gs_band_train.band_grads`` per band, the other bands' rgb
    detached): the bands' gradients summed against ``train_step``'s (its
    Adam moments and densification statistics) at 2e-6 + 1e-4 max|g|, the
    loss equal, pairs summed equal, K1-K3 once per band; K3 in band mode
    on the heaviest band against its plain version as in phase 5;
43. the distributed paths over NCCL at world size 1 (tcp on localhost)
    against the single-process functions: ``render_views_sharded`` on 14
    views of big2m and ``render_frame_sharded`` bit for bit;
    ``dp_train_step`` on two ball2m-train views, ``band_train_step`` and
    its ZeRO form with the loss equal and the gradients at 2e-6 + 1e-4
    max|g| (a train step's gradients do not repeat bit for bit: the
    gather's backward adds atomically);
44. ``data.native_io`` built from ``native/dataio.cpp`` (a missing
    ``zlib.h`` is reported, any other failure fails), ``decode_png`` of
    main path 5's 28 gen_seq PNGs equal to PIL and through
    ``PrefetchLoader``; a 20-step ``train_gs --live_view`` run on main
    path 2's scene publishing every 5 steps, whose server answers its
    page, the PNG of the current render and a posted pose, and then
    serves renders of that pose;
45. the ``kernels`` JSON line: one record per kernel, each timed alone
    at its headline shape with ``cuda_ms`` beside its least time from
    ``port_bench/counts`` (K1 and K2 at main path 1's big2m frame, K3 at
    main path 2's first step, K4 at main path 3's ds1 shape, K5 at main
    path 4's ds1 shape, K6 at SH 0 with SH 3 under ``sh3``, K7 at SH 3),
    with each main path's launches (``main_path_6/7/8/10/12``, ``band``);
    the last line is the ``ok`` JSON object.

Build outputs and the scenes go under ``build/`` in the checkout.
"""

import collections
import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
BALL_N, BIG_N = 100_000, 2_000_000
YAWS = (0.0, -0.06, 0.06, 0.12)   # the bench view and three yaw offsets

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
# Main path 10 (slice 9a), after main path 3's engine is freed: the
# blended and inversion samplers through the svd_test CLI at main path 3's
# width and shapes (K4 350 and 700 times: 25 evaluations at CFG batch 28,
# and 25 inversion plus 25 resampling evaluations at batch 14), then the
# demo_app server at simple_video_sample's (the UNet alone, no ControlNet,
# in f32 on bf16-rounded weights: K4 K4_PER_UNET_EVAL times per
# evaluation, on f32 operands). The background check (``background_bar``)
# bounds the final latent outside the latent mask from the last step's
# arithmetic; BG_NORMAL_MAX bounds |a standard normal| over the step's
# 172,032 renoise draws (P(exceeded) ~ 3e-4), BG_ULPS the f32 roundings
# of the step at the background's magnitude. Inside the mask the mean
# change must be BG_INSIDE_FACTOR times that bar, and the planted faults
# (the blend skipped, its mask inverted; BG_FAULT_STEPS steps) must fail
# it. The tiny engine runs the SamplingPipeline samplers at SAMPLING_STEPS.
BG_NORMAL_MAX, BG_ULPS, BG_INSIDE_FACTOR, BG_FAULT_STEPS = 6.0, 16, 10.0, 3
SAMPLING_STEPS = 3
K4_10_SHAPES = ((14, 3072, 5, 64, "bfloat16"), (14, 768, 10, 64, "bfloat16"),
                (28, 3072, 5, 64, "float32"))
K4_PER_UNET_EVAL = 10   # the UNet's ds1 and ds2 blocks: 2 + 3 each
DEMO_STEPS = 10         # the second request's num_steps
# One f32 uncontrolled denoiser evaluation through K4 against the plain
# attention (phase 15's discipline). With f32 activations only K4's bf16
# operands and p differ from the plain f32 attention: the sound reading is
# 0.00044 on an H100 (phase 15's bf16 network reads 0.014), the planted
# faults 0.0238 (first key tile dropped) and 0.0467 (exp2 softmax). The
# bar is near the geometric mean of 0.00044 and 0.0238 (0.0032).
DEMO_EVAL_RMS_TOL = 0.0032
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
# Main path 12 (slice 11) at world size 1 over NCCL. The frame-sharded
# forward differs from ``apply_model`` only where its temporal GroupNorms
# take their statistics in another order (f32, ~1e-7 relative); in bf16
# some outputs round the other way, and the random bf16 network spreads
# that to the bf16 floor: relative rms 0.0134 for the forward at a
# mid-ladder sigma, FS_SIGMA_STEP of 25, and 0.0113 for the 25-step
# clip's final latents on an H100 (phase 15's sound K4 reads 0.014). The
# bf16 bars, ~3 and ~4 times those readings, catch gross faults only (on
# the tiny bf16 engine a frame index shifted by one reads 0.024 against a
# floor of 0.011). So the forward is compared in f32 too, on the same
# engine cast to f32 (TF32 off) and with the plain f32 attention (K4
# rounds p to bf16 even on f32 inputs: with phase 15's q and k gain that
# alone read 1.1e-4), at FS_F32_RMS_TOL, a bar set before its first
# reading on the card: 10x above the 1e-5 that the f32 CPU test holds at
# world size 2, and far below the ~1e-2 that two planted faults move the
# tiny engine. The forward is correct when both comparisons pass; each
# planted fault (FS_FAULTS) must fail one of them. The DDP step (two
# steps, EMA 0.9999, lr DDP_LR) against ``make_train_step`` with the same
# draws: the losses within 1e-6 relative, the parameters and the EMA
# within one spacing of their type wherever Adam's first moment is at
# least 1e-7 (|g| >= 1e-6; below, the step is not sign-like and is
# counted, not compared).
FS_FORWARD_RMS_TOL, FS_CLIP_RMS_TOL, FS_SIGMA_STEP = 0.04, 0.05, 12
FS_F32_RMS_TOL = 1e-4
# Faults a port of the frame-mixing layers could make that also show at
# world size 1. (Frame 1's context in place of frame 0's would not: SVD
# repeats each video's CLIP context over its frames.)
FS_FAULTS = ("frame index + 1", "the other video's context")
DDP_LR, DDP_STEPS, DDP_LOSS_REL_TOL = 1e-4, 2, 1e-6


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


# Main path 8 (slice 8, evaluation) on main paths 5 and 6's workspace: the
# render CLI writes main path 6's recomposed PLY and main path 5's source
# PLY at the 10 bench views of CMP_YAWS (1920x1080) into the layout cmp
# reads, vis/cmp/<CMP_EXP>/{inpainted,src}/<scene>/ours_<REC_ITERS>/renders,
# and cmp scores every frame with random full-width MUSIQ (MUSIQConfig():
# 2,153 tokens per 1080p frame) and WaDIQaM-NR. Bars: MUSIQ and WaDIQaM on
# one 1080p frame, and LPIPS at full VGG16 on an LPIPS_SHAPE pair, on the
# card within METRIC_REL_TOL relative of the same weights on the CPU (f32
# sums in another order, TF32 off).
CMP_YAWS = tuple(round(-0.12 + 0.03 * i, 2) for i in range(10))
CMP_EXP, METRIC_REL_TOL, LPIPS_SHAPE = "smoke", 1e-4, (4, 512, 512, 3)
# Main path 9 (slice 9b): vae_finetune at full width (VAEConfig(), the
# ndf-64 3-layer PatchDiscriminator) on main path 5's 28 gen_seq frames at
# VAE_RES^2, batch VAE_BATCH, the perceptual term through a random full
# VGG16 LPIPS, VAE_STEPS steps, the adversarial terms gated on from step
# VAE_DISC_START. Before it, one --tiny step on the card against the CPU:
# the logs within VAE_STEP_REL_TOL relative.
VAE_RES, VAE_BATCH, VAE_STEPS, VAE_DISC_START = 256, 4, 20, 5
VAE_STEP_REL_TOL = 1e-5
# Main path 11 (slice 10): main path 1's big2m 1080p frame as BANDS
# interleaved tile-row bands rendered one after another (the per-GPU work
# of a BANDS-way band-sharded frame), main path 2's ball2m-train step
# likewise, the distributed paths over NCCL at world size 1 (DIST_VIEWS
# orbit views of big2m), native_io on main path 5's gen_seq PNGs, and a
# LIVE_STEPS-step train_gs with the live view publishing every
# LIVE_INTERVAL steps.
BANDS, DIST_VIEWS = 4, 14
LIVE_STEPS, LIVE_INTERVAL = 20, 5
LIVE_POSE = {"yaw": 30.0, "pitch": -10.0, "radius": 1.5}


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


Call = collections.namedtuple("Call", "args kw out")


@contextlib.contextmanager
def patched(owner, name, fn):
    """``owner.name`` is ``fn`` inside the block (a planted fault, or the
    plain version in a kernel's place); yields the attribute it
    replaced."""
    real = getattr(owner, name)
    setattr(owner, name, fn)
    try:
        yield real
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def capture(owner, name, keep=Call):
    """The calls to ``owner.name`` inside the block, passed through and
    recorded: the list it yields gets ``keep(args, kwargs, result)`` of
    each call once it returns (by default the three as a ``Call``)."""
    calls = []

    def run(*args, **kw):
        out = real(*args, **kw)
        calls.append(keep(args, kw, out))
        return out

    with patched(owner, name, run) as real:
        yield calls


def perturbed(torch, seed):
    """A ``capture`` keep for an engine's init: every all-zero parameter
    of the new engine moved (``perturb_zero_params``); keeps the engine."""
    def keep(args, kw, eng):
        perturb_zero_params(torch, eng, seed)
        return eng
    return keep


@contextlib.contextmanager
def spans(label):
    """The port's spans (``telemetry``, with device events on the card)
    over the block, from a reset of its records and counters (the launch
    counters too); then one line of each span's count and device ms, and
    the dict it yields filled with the snapshot's spans."""
    from multiview_inpaint_tpu_torch import telemetry
    out = {}
    telemetry.reset()
    telemetry.enable(device_events=DEVICE == "cuda")
    try:
        yield out
    finally:
        telemetry.disable()
    out.update(telemetry.snapshot()["spans"])
    print(f"[{label} spans] count, device ms: " + json.dumps(
        {k: [v["count"], round(v["device_ms"] or 0.0, 3)]
         for k, v in out.items()}), flush=True)


def timed(torch, kernel, plain, iters, plain_iters, bound_s, bound_by,
          library=None, **errors):
    """A kernel's record of the kernels line: its and its plain version's
    mean ms (``cuda_ms``), its least time ``bound_s`` (from
    ``port_bench.counts``) and what bounds it, and its ``errors``; with
    ``library`` (the same work in a PyTorch library call, run with grad
    on) also that call's mean ms as the yardstick ``library_ms``."""
    with torch.no_grad():
        rec = dict(errors, ms=cuda_ms(torch, kernel, iters),
                   plain_ms=cuda_ms(torch, plain, plain_iters),
                   bound_ms=bound_s * 1e3, bound_by=bound_by,
                   library_ms=None)
    if library is not None:
        rec["library_ms"] = cuda_ms(torch, library, iters)
        rec["vs_library"] = rec["ms"] / rec["library_ms"]
    return rec


def timing_note(rec):
    lib = ("" if rec["library_ms"] is None else
           f", library {rec['library_ms']:.4f} ms (kernel / library "
           f"{rec['vs_library']:.3f})")
    return (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms"
            f"{lib}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
            f"{rec['bound_ms'] / rec['ms']:.1%} of it)")


def composite_bound(bound_s, walk, n_pairs, n_tiles, pix):
    """(least seconds, what bounds them) of K2 or K3 (``bound_s``:
    ``port_bench.counts.composite.k2_bound_s`` or ``k3_bound_s``) on the
    walk's pair-pixels; its bytes alone are its bound on an empty walk."""
    s = bound_s(walk, n_pairs, n_tiles, pix)
    return s, ("bytes" if bound_s([0, 0, 0], n_pairs, n_tiles, pix) >= s
               else "operations")


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
    for src in ("composite.cu", "composite_bwd.cu", "project.cu",
                "project_bwd.cu"):
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
    default), on the K1 and K2 inputs of one ``render`` of it. On big2m,
    main path 1's frame, also K2's planted fault and K1's and K2's records
    of the kernels line (launches filled in later); else returns None."""
    from port_bench.counts import composite as bounds
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        RenderCamera, api, binning, composite, composite_cuda, pair_expand,
        render)
    from multiview_inpaint_tpu_torch.utils import synthetic

    cam = RenderCamera.from_camera(camera or synthetic.bench_camera(),
                                   DEVICE)
    with capture(binning, "expand_keys") as k1_calls, \
            capture(binning, "bin_gaussians") as bins, \
            capture(api, "composite_tiles") as k2_calls, torch.no_grad():
        render(params, cam, torch.zeros(3, device=DEVICE), device=DEVICE)
    k1_args = k1_calls[0].args
    # Equal keys give equal segments: both go through the same sort.
    if not torch.equal(pair_expand.expand_keys(*k1_args),
                       pair_expand.expand_keys_ref(*k1_args)):
        fail(f"K1 keys differ from the plain version on {name}")
    n_active, total = k1_args[5], k1_args[6]
    print(f"[3 K1 {name}] n={params.capacity} actives={n_active} "
          f"pairs={total}: keys equal | {card}", flush=True)

    gid = bins[0].out.order[bins[0].out.gid_sorted]   # gaussian of each pair
    k2_args = k2_calls[0].args
    attrs, seg_start, counts, tiles_x, tiles_y = k2_args[:5]
    size = (tiles_x, tiles_y, TILE, TILE, cam.width, cam.height)
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
    k2_err = float(max(e_rgb.max(), e_d.max(), e_t.max()))
    print(f"[4 K2 {name}] max abs err rgb {float(e_rgb.max()):.3g} depth "
          f"{float(e_d.max()):.3g} T {float(e_t.max()):.3g} | {bad}/{n_pix} "
          f"px beyond rgb {RGB_TOL} / depth {DEPTH_TOL} | all px within "
          f"stop-flip bound: {within} | {state_note} | {card}", flush=True)
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
    if name != "big2m":
        return None
    walk = bounds.walk_counts(*k2_args)
    k1 = timed(torch, lambda: pair_expand.expand_keys(*k1_args),
               lambda: pair_expand.expand_keys_ref(*k1_args), 50, 5,
               bounds.k1_bound_s(total, n_active), "bytes", max_abs_err=0.0)
    k2 = timed(torch, lambda: composite_cuda.composite_fwd(*k2_args),
               lambda: composite.composite_segments(*k2_args), 10, 1,
               *composite_bound(bounds.k2_bound_s, walk, attrs.shape[0],
                                tiles_x * tiles_y, TILE * TILE),
               max_abs_err=k2_err)
    print(f"[3 K1 {name}] {timing_note(k1)} | [4 K2 {name}] "
          f"{timing_note(k2)} | {card}", flush=True)
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
    forward's per-item state, then a band's row0 and stride if any), pair
    by pair and gaussian by gaussian (``compare_k3``), twice: against the
    plain K3 walking each tile from its start, which owes nothing to K2's
    state, and against the plain K3 started from that state. Fails on a
    breach of either, else returns the largest error."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (composite,
                                                            composite_cuda)

    args, band = k3_args[:10], tuple(k3_args[10:]) or (0, 1)
    counts, th, tw = args[2], args[7], args[8]
    with torch.no_grad():
        d_k = composite_cuda.composite_bwd(*args, *band)
        again = composite_cuda.composite_bwd(*args, *band)
        d_walk = composite.composite_segments_bwd(*args[:-1], None, *band)
        d_p = composite.composite_segments_bwd(*args, *band)
    if not torch.isfinite(d_k).all() or d_k[:, 10:].any():
        fail(f"K3 rows not finite, or rows 10-15 not 0, at {label}")
    if not torch.equal(d_k, again):
        fail(f"K3 does not repeat bit for bit at {label}")
    e_walk, share_w, within_w, e_gauss_w, share_gw, within_gw, ok_w = (
        compare_k3(torch, d_k, d_walk, gid, n_gauss))
    e_rows, share, within, e_gauss, share_g, within_g, ok = compare_k3(
        torch, d_k, d_p, gid, n_gauss)
    print(f"[{label}] pairs={d_k.shape[0]} in {counts.numel()} {th}x{tw} "
          f"tiles: {depth_stats(torch, counts)} | vs the plain K3 from each "
          f"tile's start: max abs err per row "
          f"{[float(f'{e:.3g}') for e in e_walk.tolist()]} | pairs beyond "
          f"{GRAD_ATOL} + {GRAD_RTOL} max|row|: {share_w:.3g} (within flip "
          f"allowance: {within_w}) | per gaussian max err "
          f"{float(e_gauss_w.max()):.3g}, beyond: {share_gw:.3g} (within: "
          f"{within_gw}) | vs the plain K3 from K2's state: max abs err per "
          f"row {[float(f'{e:.3g}') for e in e_rows.tolist()]} | pairs "
          f"beyond {share:.3g} (within: {within}) | per gaussian max err "
          f"{float(e_gauss.max()):.3g}, beyond: {share_g:.3g} (within: "
          f"{within_g}) | rows 10-15 zero, repeats bit for bit | {card}",
          flush=True)
    if not (ok_w and ok):
        fail(f"K3 disagrees with its plain version at {label}")
    return float(max(e_walk.max(), e_rows.max()))


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


def k6_bytes_per_splat(sh_degree):
    """K6's bytes a splat: xyz 12, the (d+1)^2 SH coefficients used (12
    each), opacity 4, scale 12, rotation 16 and live 1 read; means2d 8,
    conic 12, depth 4, radius 4, colour 12, opacity 4 and extent 8
    written (109 B at degree 0, 289 B at degree 3)."""
    return (12 + 12 * (sh_degree + 1) ** 2 + 4 + 12 + 16 + 1
            + 8 + 12 + 4 + 4 + 12 + 4 + 8)


K6_REL_TOL = 1e-6
# Phase 5b's degrees: 0 is main path 1's (the render CLI's default on the
# big2m PLY, which has no rest coefficients), 3 the full SH stack.
K6_DEGREES = (0, 3)


def k6_verdict(torch, got, want):
    """K6's ``ProjectedGaussians`` against the plain version's: the rows
    whose radius, extent or visibility differ, whether means2d is zero on
    every culled row, and the largest relative error of each float field
    (0 where equal, NaN where only one side is NaN)."""
    vis = want.radius > 0
    rows = {"radius": int((got.radius != want.radius).sum()),
            "extent": int((got.extent != want.extent).any(-1).sum()),
            "visible": int(((got.radius > 0) != vis).sum())}
    rel = {}
    for f in ("means2d", "conic", "depth", "color", "opacity"):
        a, b = getattr(got, f), getattr(want, f)
        same = (a == b) | (a.isnan() & b.isnan())
        rel[f] = float(torch.where(same, 0.0, (a - b).abs() / b.abs()).max())
    culled_zero = not bool(got.means2d[~vis].any())
    return rows, culled_zero, rel


def phase_project(torch, card):
    """Phase 5b: K6 on the 2M-gaussian scene in the 1080p bench view
    against its plain version on the card, then both timed beside K6's
    bytes bound, at each of ``K6_DEGREES``: degree 0 on main path 1's own
    params (no rest coefficients), degree 3 on the same with seeded rest
    coefficients. Returns K6's record of the kernels line: the degree-0
    numbers at the top, as the launches filled in later are main path 1's
    at degree 0, and the degree-3 ones under ``sh3``."""
    from port_bench.counts import peaks
    from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera,
                                                            project_cuda)
    from multiview_inpaint_tpu_torch.utils import synthetic
    base = synthetic.make_big_scene(BIG_N, device=DEVICE)
    cam = RenderCamera.from_camera(synthetic.bench_camera(), DEVICE)
    records = {}
    for sh in K6_DEGREES:
        params = synthetic.with_sh_rest(base, sh) if sh else base
        with torch.no_grad():
            got = project_cuda.project(params, cam, sh)
            want = project_cuda.project_ref(params, cam, sh)
        rows, culled_zero, rel = k6_verdict(torch, got, want)
        visible = int((want.radius > 0).sum())
        del got, want
        per_splat = k6_bytes_per_splat(sh)
        rec = timed(torch, lambda: project_cuda.project(params, cam, sh),
                    lambda: project_cuda.project_ref(params, cam, sh), 50, 5,
                    BIG_N * per_splat / peaks.HBM_BYTES_PER_S, "bytes",
                    max_abs_err=None, max_rel_err=max(rel.values()))
        print(f"[5b K6 big2m SH {sh}] n={BIG_N}, "
              f"{params.features_rest.shape[1]} rest coefficients, "
              f"1920x1080, {visible} visible: rows differing {rows} | "
              f"means2d zero on culled rows {culled_zero} | max relative "
              f"error {rel} | {timing_note(rec)}, {per_splat} B a splat | "
              f"{card}", flush=True)
        if any(rows.values()) or not culled_zero or not all(
                e <= K6_REL_TOL for e in rel.values()):
            fail(f"K6 disagrees with its plain version on big2m at SH "
                 f"degree {sh}")
        records[sh] = rec
        del params
    return dict(sh_degree=0, **records[0], sh3=records[3])


def k7_bytes_per_splat(sh_degree):
    """K7's bytes a splat: the parameters K6 reads less live (xyz 12,
    the (d+1)^2 SH coefficients used 12 each, opacity 4, scale 12,
    rotation 16), the radius 4 and the 10 cotangents 40 read; their
    gradients and the offset's 8 written (524 B at degree 3)."""
    params = 12 + 12 * (sh_degree + 1) ** 2 + 4 + 12 + 16
    return params + 4 + 40 + params + 8


# K7 against its plain version: every finite entry of a visible row
# within K7_RTOL of its own size plus K7_ATOL of its field's largest.
K7_RTOL = 1e-4
K7_ATOL = 1e-5
K7_DEGREE = 3


def phase_project_bwd(torch, card):
    """Phase 5c: K7 on the 2M-gaussian scene in the 1080p bench view at
    SH degree 3, its rotations seeded normal quaternions and its
    log-scales spread by seeded normal draws (so that every term of the
    rotation and scale chains is live), the cotangents columns of one
    seeded packed gradient, against its plain version on the card; culled
    rows zero, NaN where the plain version's, finite entries within
    K7_RTOL plus K7_ATOL of the field's largest; K7 and the plain version
    timed beside K7's bytes bound. Returns K7's record of the kernels
    line."""
    from port_bench.counts import peaks
    from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera,
                                                            project_cuda)
    from multiview_inpaint_tpu_torch.utils import synthetic
    sh = K7_DEGREE
    params = synthetic.with_sh_rest(synthetic.make_big_scene(
        BIG_N, device=DEVICE), sh)
    g = torch.Generator(device=DEVICE).manual_seed(7)
    params = dataclasses.replace(
        params, rotation=torch.randn((BIG_N, 4), generator=g,
                                     device=DEVICE),
        scaling=params.scaling + 0.5 * torch.randn(
            (BIG_N, 3), generator=g, device=DEVICE))
    cam = RenderCamera.from_camera(synthetic.bench_camera(), DEVICE)
    with torch.no_grad():
        proj = project_cuda.project(params, cam, sh)
    vis = proj.radius > 0
    packed = torch.randn((BIG_N, 16), generator=g, device=DEVICE) \
        * vis[:, None]
    cots = [packed[:, 0:2], packed[:, 2:5], packed[:, 9], packed[:, 6:9],
            packed[:, 5]]
    args = (params, cam, sh, 1.0, proj.radius, cots)
    got = project_cuda.project_bwd(*args)
    want = project_cuda.project_bwd_ref(*args)
    rel, culled_zero, nan_same, close = {}, True, True, True
    for f, a, b in zip(got._fields, got, want):
        culled_zero = culled_zero and not a[~vis].any()
        nan_same = nan_same and torch.equal(a.isnan(), b.isnan())
        rows = vis.reshape((BIG_N,) + (1,) * (b.dim() - 1))
        fin = torch.isfinite(b) & rows
        x, y = a[fin], b[fin]
        top = y.abs().max().clamp(min=1e-30)
        rel[f] = float((x - y).abs().max() / top)
        close = close and bool(((x - y).abs()
                                <= K7_RTOL * y.abs() + K7_ATOL * top).all())
    del got, want
    per_splat = k7_bytes_per_splat(sh)
    rec = timed(torch, lambda: project_cuda.project_bwd(*args),
                lambda: project_cuda.project_bwd_ref(*args), 50, 5,
                BIG_N * per_splat / peaks.HBM_BYTES_PER_S, "bytes",
                max_abs_err=None, max_rel_err=max(rel.values()))
    print(f"[5c K7 big2m SH {sh}] n={BIG_N}, 1920x1080, {int(vis.sum())} "
          f"visible: culled rows zero {culled_zero} | NaN where the plain "
          f"version's {nan_same} | within {K7_RTOL} relative plus "
          f"{K7_ATOL} of the field's largest {close} | max error over the "
          f"field's largest {rel} | {timing_note(rec)}, {per_splat} B a "
          f"splat | {card}", flush=True)
    if not (culled_zero and nan_same and close):
        fail(f"K7 disagrees with its plain version on big2m at SH degree "
             f"{sh}")
    return dict(sh_degree=sh, **rec)


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
    render_cli.main(["-s", src, "-m", model, "--resolution", "1",
                     "--skip_test", "--device", DEVICE])
    launches = dict(_kernels.LAUNCHES)
    n_views = len(names)
    if launches != _forward_launches(n_views):
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
          f"at 1920x1080 (PNGs written) | launches {launches} | {card}",
          flush=True)
    check_frames(torch, card, f"big2m ({BIG_N} gaussians, from the PLY)",
                 gaussians.load_ply(ply, 0, device=DEVICE))
    check_frames(torch, card, f"ball100k ({BALL_N} gaussians)",
                 synthetic.make_bench_ball(BALL_N, device=DEVICE))
    return launches


def check_frames(torch, card, name, params):
    """``render`` of the YAWS views; fails on a frame
    that is not finite or is constant."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera,
                                                            render)
    from multiview_inpaint_tpu_torch.utils import synthetic

    bg = torch.zeros(3, device=DEVICE)
    pairs = []
    with torch.no_grad():
        for y in YAWS:
            out = render(params, RenderCamera.from_camera(
                synthetic.bench_camera(y), DEVICE), bg, device=DEVICE)
            pairs.append(out.pairs)
            if not (torch.isfinite(out.rgb).all()
                    and torch.isfinite(out.depth).all()
                    and float(out.rgb.std()) > 0):
                fail(f"{name}: frame not finite or constant")
    print(f"[9 frames {name}] {len(YAWS)} views at 1920x1080 finite and not "
          f"constant, pairs {pairs} | {card}", flush=True)


def kernel_inputs(run):
    """``run()`` with K1's and K3's calls and the pair binning captured:
    its result, K1's arguments, K3's (ten, then a band's row0 and stride)
    and the gaussian of each pair, all of the last such calls."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (binning,
                                                            composite_cuda)
    with capture(binning, "bin_gaussians",
                 lambda a, kw, b: b.order[b.gid_sorted]) as gid, \
            capture(binning, "expand_keys") as k1, \
            capture(composite_cuda, "composite_bwd") as k3:
        out = run()
    return out, k1[-1].args, k3[-1].args, gid[-1]


def phase_train(torch, card):
    """Main path 2: one train step of the orbit scene (K3 held against its
    plain version there and timed, K1 and K2 checked on its inputs), then
    the train_gs CLI on that scene; returns the launch counts of the CLI
    run and K3's record for the kernels line."""
    from port_bench.counts import composite as bounds
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.gs.scene import Scene
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        RenderCamera, composite, composite_cuda)
    from multiview_inpaint_tpu_torch.pipelines import train_gs
    from multiview_inpaint_tpu_torch.utils import synthetic

    iterations = TRAIN_ITERS
    work = os.path.join(REPO, "build", "smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    src = os.path.join(work, "scene")
    model = os.path.join(work, "model")
    names = synthetic.write_orbit_colmap_scene(
        src, synthetic.make_big_scene(BIG_N, device=DEVICE),
        np.linspace(-0.35, 0.35, TRAIN_VIEWS), TRAIN_W, TRAIN_H,
        TRAIN_POINTS)

    # The CLI's first step: its scene, init and loss, on one of its views.
    scene = Scene(src, os.path.join(work, "first_step"), resolution=1,
                  device=DEVICE)
    cam = scene.train_cameras()[0]
    (state, _), k1_args, k3_args, gid = kernel_inputs(
        lambda: gs_trainer.train_step(
            gs_trainer.init_state(scene.gaussians),
            RenderCamera.from_camera(cam, DEVICE),
            torch.as_tensor(np.asarray(cam.image, np.float32),
                            device=DEVICE),
            torch.zeros(3, device=DEVICE), gs_trainer.OptimizationConfig(),
            scene.cameras_extent))
    err = check_k3(torch, card, "10 K3 orbit-train first step", k3_args,
                   gid, state.params.capacity)
    attrs, seg_start, counts, _, _, tiles_x, tiles_y, th, tw = k3_args[:9]
    walk = bounds.walk_counts(attrs, seg_start, counts, tiles_x, tiles_y,
                              th, tw)
    k3 = timed(torch, lambda: composite_cuda.composite_bwd(*k3_args),
               lambda: composite.composite_segments_bwd(*k3_args), 5, 1,
               *composite_bound(bounds.k3_bound_s, walk, attrs.shape[0],
                                tiles_x * tiles_y, th * tw),
               max_abs_err=err)
    print(f"[10 K3 orbit-train first step] {timing_note(k3)} | {card}",
          flush=True)
    k2_with_state(torch, card, k1_args, k3_args, "10", "orbit-train")
    seen = state.stats.denom > 0
    threshold = float(torch.quantile(state.stats.grad_accum[seen],
                                     DENSIFY_QUANTILE))
    capacity = TRAIN_POINTS + TRAIN_SPARE_ROWS
    del scene, state, k1_args, k3_args, gid

    _kernels.reset_launches()
    train_gs.main([
        "-s", src, "-m", model, "--resolution", "1",
        "--iterations", str(iterations), "--densify_from_iter", "20",
        "--densify_until_iter", "50", "--densification_interval", "20",
        "--densify_grad_threshold", repr(threshold),
        "--capacity", str(capacity), "--opacity_reset_interval", "100000",
        "--test_iterations", str(iterations),
        "--save_iterations", str(iterations),
        "--checkpoint_iterations", str(iterations), "--log_interval", "10",
        "--device", DEVICE,
    ])
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
        "K6 once per step and evaluation render, K7 once per step":
        launches["project"] == iterations + n_eval
        and launches["project_bwd"] == iterations,
    }
    densify = [{k: r[k] for k in ("step", "cloned", "split", "pruned",
                                  "wanted", "granted")} for r in densified]
    print(f"[10 main train] train_gs CLI, {iterations} iterations on "
          f"{len(names)} views at {TRAIN_W}x{TRAIN_H} (GT rendered from "
          f"{BIG_N} gaussians, {TRAIN_POINTS} init points in {capacity} "
          f"rows) | loss "
          f"{[round(r['loss'], 5) for r in steps]} | points "
          f"{last.get('points')} capacity {last.get('capacity')} pairs "
          f"{last.get('pairs')} | densify threshold {threshold:.4g} (the "
          f"{DENSIFY_QUANTILE} quantile of the first step), {densify} | "
          f"psnr {[round(r['psnr'], 3) for r in evals]} | launches "
          f"{launches} | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 2 (train CLI) checks failed: {checks}")
    return launches, k3


def k2_with_state(torch, card, k1_args, k3_args, label, cell):
    """K1 and K2 on the inputs of a train step (``kernel_inputs``): K1's
    keys bit-equal to the plain version's; K2 with and without the
    per-item state: tiles bit-equal and equal to the step's, the state
    equal to the step's and held against the plain K2's
    (``compare_state``)."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        composite, composite_cuda, pair_expand)

    if not torch.equal(pair_expand.expand_keys(*k1_args),
                       pair_expand.expand_keys_ref(*k1_args)):
        fail(f"K1 keys differ from the plain version at {cell}")
    attrs, seg_start, counts, tiles8, _, *size, state = k3_args[:10]
    n_items = int(composite.item_ends(counts)[-1])  # rows past it are unset
    k2_args = (attrs.detach(), seg_start, counts, *size)
    with torch.no_grad():
        plain = composite_cuda.composite_fwd(*k2_args)
        with_st, st = composite_cuda.composite_fwd(*k2_args, with_state=True)
        _, st_p = composite.composite_segments(*k2_args, with_state=True)
    note = compare_state(torch, f"{label} K2 {cell}", k2_args[0], counts,
                         st, st_p)
    same = (torch.equal(plain, with_st) and torch.equal(plain, tiles8)
            and torch.equal(st[:n_items], state[:n_items]))
    print(f"[{label} K1, K2 {cell}] actives {k1_args[5]} pairs "
          f"{k1_args[6]}: keys equal | K2 tiles equal with and without the "
          f"per-item state ({tuple(st.shape)}, {st.numel() * 4 / 1e6:.1f} "
          f"MB) and equal to the step's, state equal to the step's: {same} "
          f"| {note} | {card}", flush=True)
    if not same:
        fail(f"K2's tiles or state differ with the state output at {cell}")


def phase_step_full(torch, card):
    """The train step at full width: 12 steps, each with
    a finite loss and gradients; the last one's K3 call against the plain
    K3, then fed a planted next-item state."""
    from multiview_inpaint_tpu_torch.models import gs_trainer

    params, cam, gt, bg = _step_cell(torch)
    cfg = gs_trainer.OptimizationConfig()
    state = gs_trainer.init_state(params)
    for _ in range(11):
        state, m = gs_trainer.train_step(state, cam, gt, bg, cfg, 1.0)
        if not torch.isfinite(m.loss) or int(m.nonfinite_grads):
            fail("full-width train step: loss or gradients not finite")
    (state, m), _, k3_args, gid = kernel_inputs(
        lambda: gs_trainer.train_step(state, cam, gt, bg, cfg, 1.0))
    if not torch.isfinite(m.loss) or int(m.nonfinite_grads):
        fail("full-width train step: loss or gradients not finite")
    print(f"[11 step] {STEP_N} gaussians in {STEP_CAPACITY} rows at "
          f"{STEP_W}x{STEP_H}, pairs {m.pairs}: 12 steps, loss and "
          f"gradients finite | {card}", flush=True)
    check_k3(torch, card, "11 K3 ball2m-train step", k3_args, gid,
             state.params.capacity)
    k3_fault(torch, card, "11 K3 planted fault", k3_args[:10], gid,
             state.params.capacity)


def phase_k4(torch, card, shapes, label, headline=False):
    """K4 against its plain version on packed [B, T, H*D] inputs at a
    main path's shapes. With ``headline`` (main path 3's shapes) its bf16
    shapes, ds1 and ds2, are also timed beside their bound; returns their
    records for the kernels line (launches filled in later). The launches
    made here are taken off the counters again."""
    import torch.nn.functional as F

    from port_bench.counts import attention, peaks
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
        note = ""
        if headline and dtype == "bfloat16":
            bound_s = attention.k4_bound_s(b, h, t, d, q.element_size())
            t_bytes = 4 * q.numel() * q.element_size() / peaks.HBM_BYTES_PER_S
            qh, kh, vh = (x.view(b, t, h, d).transpose(1, 2)
                          for x in (q, k, v))
            rec = timed(torch, lambda: fa.flash_attention(q, k, v, h, scale),
                        lambda: fa.flash_attention_ref(q, k, v, h, scale),
                        20, 3, bound_s,
                        "operations" if bound_s > t_bytes else "bytes",
                        library=lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, scale=scale),
                        max_abs_err=err)
            records.append(rec)
            note = (f" | {timing_note(rec)}, "
                    f"{attention.k4_flop(b, h, t, d) / rec['ms'] / 1e9:.1f} "
                    f"TFLOP/s")
        print(f"[{label} K4 {dtype} [{b}, {t}, {h}*{d}], {h} heads] max abs "
              f"err {err:.4g} (bar {K4_ABS_TOL}), rel {rel:.4g} (bar "
              f"{K4_REL_TOL}) | bit-equal on a second run: {equal}, equal "
              f"to K4 on the folded [{b * h}, {t}, {d}]: {same_folded}"
              f"{note} | {card}", flush=True)
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


def phase_svd_main(torch, card):
    """Main path 3: the svd_test CLI at full width on a synthetic gs/ tree
    (1 scene, 1 ctrl, mode x1), every all-zero parameter of the random
    engine moved, under the spans; returns the launch counts, the engine
    and the sampler's conditioning (c, uc)."""
    from PIL import Image

    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion.engine import SVDEngine
    from multiview_inpaint_tpu_torch.pipelines import svd_test
    from multiview_inpaint_tpu_torch.utils import synthetic

    work = os.path.join(REPO, "build", "smoke_svd")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "gs")
    synthetic.write_gs_tree(root, scene="scene_case", ctrl="ctrl_0",
                            modes=("x1",), frames=SVD_FRAMES,
                            size=(SVD_H, SVD_W), iteration=30000)
    _kernels.reset_launches()
    with capture(svd_test, "init_engine", perturbed(torch, 7)) as engines, \
            capture(SVDEngine, "sample") as samples, \
            spans("14 main svd") as sp:
        svd_test.main(["--data_root", root, "--logdir",
                       os.path.join(work, "logs"), "--modes", "x1",
                       "--num_frames", str(SVD_FRAMES), "--num_steps",
                       str(SVD_STEPS), "--size", str(SVD_H), str(SVD_W),
                       "--device", DEVICE])
    launches = dict(_kernels.LAUNCHES)
    eng = engines[0]
    out_dir = os.path.join(root, "inpainted", "scene_case", "ctrl_0", "x1")
    pngs = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    finite = []
    for p in pngs:
        with Image.open(os.path.join(out_dir, p)) as im:
            arr = np.asarray(im, np.float32)
        finite.append(arr.shape == (SVD_H, SVD_W, 3)
                      and bool(np.isfinite(arr).all()))
    want = K4_PER_EVAL * SVD_STEPS
    checks = {
        f"{SVD_FRAMES} frames written": len(pngs) == SVD_FRAMES,
        f"frames finite, {SVD_H}x{SVD_W}": bool(finite) and all(finite),
        f"K4 launched {want} times": launches["flash_attn_fwd"] == want,
        "no rasterizer kernel": launches["composite"] == 0,
        f"{SVD_STEPS} denoiser evaluations":
        sp.get("engine.eval", {}).get("count") == SVD_STEPS,
    }
    print(f"[14 main svd] svd_test CLI, "
          f"{sum(p.numel() for p in eng.parameters())} parameters (bf16; "
          f"the VAE f32) made on the card, {SVD_FRAMES} frames at "
          f"{SVD_H}x{SVD_W}, {SVD_STEPS} steps, CFG batch {2 * SVD_FRAMES} | "
          f"launches {launches} | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 3 (svd_test CLI) checks failed: {checks}")
    return launches, eng, samples[0].args[1:3]


def phase_svd_eval(torch, card, eng, conds):
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

    cond, uc = conds
    shape = (SVD_FRAMES, SVD_H // 8, SVD_W // 8, 4)
    sigma = torch.full((SVD_FRAMES,), eng.cfg.sigma_max, device=DEVICE)
    with torch.no_grad():
        for m in eng.modules():
            if isinstance(m, CrossAttention):
                m.to_q.weight.mul_(SVD_QK_GAIN)
                m.to_k.weight.mul_(SVD_QK_GAIN)
    real = attention_op.flash_attention
    ref = flash_attention.flash_attention_ref

    def evaluate(seed, attend):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        x = torch.randn(shape, generator=gen, device=DEVICE) * float(
            (1 + eng.cfg.sigma_max ** 2) ** 0.5)
        with patched(attention_op, "flash_attention", attend):
            _kernels.reset_launches()
            gx, gs, gc = eng.guider.prepare(x, sigma, cond, uc)
            out = eng.denoise_fn()(gx, gs, gc)
        return out, _kernels.LAUNCHES["flash_attn_fwd"]

    out_k4, n_k4 = evaluate(11, real)
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
          f"{SVD_QK_GAIN}: K4 "
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


def phase_frame_sharded(torch, card, eng, conds):
    """Main path 12 (a), on main path 3's engine (phase 15's q and k
    scaling kept) and conditioning: NCCL at world size 1 (tcp on
    localhost); one ``frame_sharded_apply_model`` of svd-clip's CFG batch
    of 28 rows at 512x384 against ``engine.apply_model``, its collectives
    counted; then a 25-step clip through ``make_frame_sharded_denoiser``
    against ``engine.sample`` from the same noise, counters zeroed before
    the sharded clip; then the forward with each of FS_FAULTS planted, and
    all of it again on the engine cast to f32 (which frees main path 3's
    bf16 weights) with ``attention_op``'s K4 call patched to the plain
    f32 attention, since K4 rounds p to bf16 before p.v whatever the
    input type. Returns the sharded clip's launches."""
    import torch.distributed as dist

    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import (attention_op, edm,
                                                       flash_attention)
    from multiview_inpaint_tpu_torch.diffusion.engine import SVDEngine
    from multiview_inpaint_tpu_torch.parallel import mesh
    from multiview_inpaint_tpu_torch.parallel import (
        svd_inference_parallel as sp)

    cond, uc = conds
    shape = (SVD_FRAMES, SVD_H // 8, SVD_W // 8, 4)
    noise = torch.randn(shape, generator=torch.Generator(
        device=DEVICE).manual_seed(31), device=DEVICE)
    sigma = eng._ladder(SVD_STEPS)[FS_SIGMA_STEP]
    gx, gs, gc = eng.guider.prepare(noise * sigma, sigma.expand(SVD_FRAMES),
                                    cond, uc)
    _, _, c_in, c_noise = edm.SCALINGS[eng.cfg.scaling](gs)
    xs = gx * c_in.reshape(-1, 1, 1, 1)
    index, bind = sp.FrameShard.frame_index, sp.FrameShard.bind

    def other_context(self, *a):
        shard = bind(self, *a)
        return dataclasses.replace(
            shard, video_context=shard.video_context.roll(1, 0))

    plant = {
        "frame index + 1": ("frame_index", lambda self, device: (
            index(self, device) + 1) % self.frames),
        "the other video's context": ("bind", other_context),
    }

    def forward(fault=None):
        """The sharded forward, ``fault`` planted in ``FrameShard``."""
        with (patched(sp.FrameShard, *plant[fault]) if fault
              else contextlib.nullcontext()), torch.no_grad():
            return sp.frame_sharded_apply_model(eng, xs, c_noise, gc)

    def readings():
        """Each planted fault's relative rms against ``apply_model``."""
        with torch.no_grad():
            want = eng.apply_model(xs, c_noise, gc)
        return {f: _rms(forward(f), want) for f in FS_FAULTS}

    def clip(denoise_fn):
        return SVDEngine.sample(eng, cond, uc, noise=noise,
                                num_steps=SVD_STEPS, denoise_fn=denoise_fn)

    def nbytes(args, kw, out):
        return args[0].numel() * args[0].element_size()

    mesh.init(0, 1, f"tcp://127.0.0.1:{_free_port()}", DEVICE)
    try:
        backend = dist.get_backend()
        with torch.no_grad():
            want = eng.apply_model(xs, c_noise, gc)
        with capture(mesh, "all_to_all_rows", nbytes) as a2a, \
                capture(mesh, "all_gather_rows", nbytes) as gathers:
            _kernels.reset_launches()
            got = forward()
            fwd_k4 = _kernels.LAUNCHES["flash_attn_fwd"]
        calls = {"all_to_all_rows": [len(a2a), sum(a2a)],
                 "all_gather_rows": [len(gathers), sum(gathers)]}
        z_ref = clip(None)
        _kernels.reset_launches()
        z_fs = clip(sp.make_frame_sharded_denoiser(eng))
        launches = dict(_kernels.LAUNCHES)
        faults = {"bf16": readings()}
        eng.unet.float()
        eng.controlnet.float()
        eng.compute_dtype = torch.float32
        torch.cuda.empty_cache()
        with patched(attention_op, "flash_attention",
                     flash_attention.flash_attention_ref):
            with torch.no_grad():
                want32 = eng.apply_model(xs, c_noise, gc)
            f32_rms = _rms(forward(), want32)
            faults["f32"] = readings()
    finally:
        dist.destroy_process_group()
    fwd_rms, clip_rms = _rms(got, want), _rms(z_fs, z_ref)
    bars = {"bf16": FS_FORWARD_RMS_TOL, "f32": FS_F32_RMS_TOL}
    caught = {f: any(faults[k][f] > bars[k] for k in bars)
              for f in FS_FAULTS}
    want_k4 = K4_PER_EVAL * SVD_STEPS
    checks = {
        "nccl": backend == "nccl",
        f"forward within {FS_FORWARD_RMS_TOL}": fwd_rms <= FS_FORWARD_RMS_TOL,
        f"f32 forward within {FS_F32_RMS_TOL}": f32_rms <= FS_F32_RMS_TOL,
        "each planted fault fails a bar": all(caught.values()),
        f"clip within {FS_CLIP_RMS_TOL}": clip_rms <= FS_CLIP_RMS_TOL,
        "finite": bool(torch.isfinite(got).all() and torch.isfinite(
            z_fs).all() and torch.isfinite(want32).all()),
        f"K4 {K4_PER_EVAL} per forward": fwd_k4 == K4_PER_EVAL,
        f"K4 launched {want_k4} times": launches["flash_attn_fwd"] == want_k4,
    }
    print(f"[15s frame-sharded] {backend} at world size 1 on main path 3's "
          f"engine: one forward of "
          f"{xs.shape[0]} rows at sigma {float(sigma):.4g}, relative rms "
          f"against apply_model {fwd_rms:.4g} (max abs "
          f"{float((got - want).abs().max()):.4g} of max|out| "
          f"{float(want.abs().max()):.4g}), bar {FS_FORWARD_RMS_TOL}; in "
          f"f32 {f32_rms:.4g}, bar {FS_F32_RMS_TOL} | planted faults' "
          f"relative rms "
          f"{json.dumps(faults)}, each caught {json.dumps(caught)} | "
          f"collectives per evaluation (calls, bytes handed in): "
          f"{json.dumps(calls)} | {SVD_STEPS}-step clip, sharded against "
          f"engine.sample: final latents' relative rms {clip_rms:.4g}, bar "
          f"{FS_CLIP_RMS_TOL} | launches "
          f"{launches} | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 12 (frame-sharded sampling) checks failed: "
             f"{checks}")
    return launches


def phase_shard_frames_cli(torch, card):
    """Main path 12 (b): the ``svd_test`` CLI with ``--shard_frames`` in
    one process (world size 1) on main path 3's tree, arguments and
    weights (the same all-zero parameters moved), counters zeroed before:
    it prints that the flag is ignored, as the JAX CLI on one device, and
    writes main path 3's 14 frames (each value within 1 uint8 level; how
    many differ at all is printed), K4 launched 350 times."""
    from PIL import Image

    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.pipelines import svd_test

    work = os.path.join(REPO, "build", "smoke_svd")
    root = os.path.join(work, "gs")
    out = os.path.join(work, "shard_frames")
    shutil.rmtree(out, ignore_errors=True)
    buf = io.StringIO()
    with capture(svd_test, "init_engine", perturbed(torch, 7)), \
            contextlib.redirect_stdout(buf):
        _kernels.reset_launches()
        svd_test.main(["--data_root", root, "--logdir",
                       os.path.join(work, "logs_shard"), "--modes", "x1",
                       "--num_frames", str(SVD_FRAMES), "--num_steps",
                       str(SVD_STEPS), "--size", str(SVD_H), str(SVD_W),
                       "--device", DEVICE, "--shard_frames", "--out", out])
    launches = dict(_kernels.LAUNCHES)
    text = buf.getvalue()
    sub = os.path.join("scene_case", "ctrl_0", "x1")
    want_dir = os.path.join(root, "inpainted", sub)
    got_dir = os.path.join(out, sub)
    names = sorted(os.listdir(want_dir))
    worst, differ = 0, 0
    got_names = sorted(os.listdir(got_dir)) if os.path.isdir(got_dir) else []
    for n in names if got_names == names else []:
        with Image.open(os.path.join(got_dir, n)) as a, \
                Image.open(os.path.join(want_dir, n)) as b:
            a, b = (np.asarray(im, np.int16) for im in (a, b))
        worst = max(worst, int(np.abs(a - b).max()))
        differ += int((a != b).sum())
    want_k4 = K4_PER_EVAL * SVD_STEPS
    checks = {
        "ignored line": "shard_frames ignored" in text,
        f"{SVD_FRAMES} frames": len(names) == SVD_FRAMES
        and got_names == names,
        "within 1 level of main path 3's": worst <= 1,
        f"K4 launched {want_k4} times": launches["flash_attn_fwd"] == want_k4,
    }
    print(f"[15t svd_test --shard_frames] one process; it printed "
          f"{text.splitlines()[:1]} | {len(got_names)} frames "
          f"against main path 3's: max difference {worst} levels, "
          f"{differ} of {SVD_FRAMES * SVD_H * SVD_W * 3} values differ | "
          f"launches {launches} | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 12 (svd_test --shard_frames) checks failed: "
             f"{checks}")
    return launches


def phase_sampling_engine(torch, card):
    """The tiny SVD engine on DEVICE against the CPU with phase 13's
    weights and bars, main path 10's samplers from the same noise and
    draws: ``sample_blended`` and ``sample_inversion`` (2 steps), the
    ``SamplingPipeline`` with Heun, Euler ancestral, DPM++(2S) ancestral
    and LMS (SAMPLING_STEPS steps), and the latent dump of a blended
    sample (file names, sigma ladder, the last latent equal to the
    result)."""
    from multiview_inpaint_tpu_torch.diffusion import api, engine, samplers

    cfg = _tiny_svd_config()
    cpu = engine.init_engine(cfg, seed=0, device="cpu")
    moved = perturb_zero_params(torch, cpu, 1)
    gpu = engine.init_engine(cfg, seed=1, device=DEVICE)
    gpu.load_reference_state_dict(cpu.reference_state_dict())
    rng = np.random.default_rng(5)
    shape = (3, 8, 6, 4)

    def normal():
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    noise, z = normal(), normal()
    draws = [normal() for _ in range(SAMPLING_STEPS)]
    mask = torch.zeros(shape)
    mask[:, 2:6, 1:4] = 1.0
    pipes = ("HEUN_EDM", "EULER_ANCESTRAL", "DPMPP2S_ANCESTRAL",
             "LINEAR_MULTISTEP")
    outs, tops, dumps = [], [], {}
    for eng, dev in ((cpu, "cpu"), (gpu, DEVICE)):
        b = _svd_batch(torch, 3, 64, 48, dev, 2)
        c = eng.prepare_cond(b)
        uc = eng.prepare_cond(b, unconditional=True)
        uc["control_hint"] = c["control_hint"]
        zm = (z.to(dev), mask.to(dev))
        out = {"blended": eng.sample_blended(
            c, uc, *zm, noise=noise, num_steps=2, renoise=draws[:2])}
        inverted = []
        prev = samplers.set_latent_debug_hook(
            lambda tag, s, x: inverted.append(x) if tag == "invert" else 0)
        try:
            out["inversion"] = eng.sample_inversion(c, uc, *zm, noise=noise,
                                                    num_steps=2)
        finally:
            samplers.set_latent_debug_hook(prev)
        tops.append(torch.from_numpy(inverted[-1]))
        for name in pipes:
            pipe = api.SamplingPipeline(eng.denoise_fn(), api.SamplingParams(
                sampler=api.Sampler[name], steps=SAMPLING_STEPS,
                num_frames=3))
            kw = dict(ancestral=draws) if name.endswith("ANCESTRAL") else {}
            with torch.no_grad():
                out[name] = pipe.sample(shape, c, uc, noise=noise,
                                        device=dev, **kw)
        d = os.path.join(REPO, "build", "smoke_dump", dev)
        shutil.rmtree(d, ignore_errors=True)
        with samplers.latent_dump(d):
            last = eng.sample_blended(c, uc, *zm, noise=noise, num_steps=2,
                                      renoise=draws[:2])
        files = sorted(os.listdir(d))
        dumps[dev] = dict(
            files=files == ["latent_000_blended.npy",
                            "latent_001_blended.npy", "latent_sigmas.npy"],
            sigmas=np.array_equal(np.load(os.path.join(d, files[-1])),
                                  engine.edm.edm_sigmas(2).numpy()),
            last=np.array_equal(np.load(os.path.join(d, files[1])),
                                last.cpu().numpy()))
        outs.append({k: v.cpu() for k, v in out.items()})
    x0 = samplers.prepare_x(noise, torch.tensor([cfg.sigma_max])).abs()
    ratio = {}
    for k, want in outs[0].items():
        start = (mask * x0 + (1 - mask) * tops[0].abs() if k == "inversion"
                 else x0)
        bar = (SVD_F32_REL_TOL * float(want.abs().max())
               + SVD_X0_ULPS * f32_spacing(torch, start))
        ratio[k] = float(((outs[1][k] - want).abs() / bar).max())
    ok = (all(v <= 1 for v in ratio.values())
          and all(all(d.values()) for d in dumps.values()))
    print(f"[15a sampling engine] tiny engine {DEVICE} vs cpu (f32, TF32 "
          f"off, {moved} all-zero parameters moved, noise and draws "
          f"injected): max |err| / bar "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in ratio.items()})} "
          f"(bar {SVD_F32_REL_TOL} of max|latents| + {SVD_X0_ULPS} f32 "
          f"spacings at the entry's magnitude entering the first step: "
          f"|x0|, the top inverted latent outside the inversion's mask) | "
          f"blended latent dump (files, sigma ladder, last latent = "
          f"result) {json.dumps(dumps)} | {card}", flush=True)
    if not ok:
        fail(f"main path 10's samplers on {DEVICE} disagree with the cpu")


def background_bar(torch, eng, mode, z, mask, evals, invs):
    """The bar on max |final latent - background ``z``| outside the latent
    mask, from the last step (sigma_hat = sigma_min; a v-scaling denoiser
    D = c_skip x + c_out F with c_skip = 1 / (sigma^2 + 1), |c_out| <=
    sigma; the Euler step to 0 returns D):
    - blended: x enters as z + sigma n (n the renoise), so D - z =
      (c_skip - 1) z + c_skip sigma n + c_out F_g: at most sigma^2 |z| +
      sigma (BG_NORMAL_MAX + |F_g|), F_g the guided network output of
      that evaluation;
    - inversion: x enters as the first inverted latent, (sigma^2 + 1) z +
      sigma sqrt(sigma^2 + 1) F_inv (F_inv the first inversion
      evaluation's raw output), so D - z is at most 2 sigma^2 |z| + sigma
      (sqrt(sigma^2 + 1) |F_inv| + |F|);
    plus BG_ULPS f32 spacings at the background's magnitude. ``evals``
    and ``invs`` are the run's captured ``edm.denoise`` and
    ``edm.raw_net_out`` calls. F is recovered in f64 from the last
    evaluation, (D - c_skip x) / c_out, and combined by the engine's
    guider."""
    last = evals[-1]
    x, s, d = (t.double() for t in (last.args[1], last.args[2], last.out))
    sigma = float(s[0])
    c_skip, c_out = 1 / (sigma ** 2 + 1), -sigma / math.sqrt(sigma ** 2 + 1)
    f = (d - c_skip * x) / c_out
    if mode == "blended":
        f = eng.guider.combine(f, s)
    out = mask == 0
    z_max = float(z.double().abs()[out].max())
    f_max = float(f.abs()[out].max())
    spacing = float(f32_spacing(torch, torch.tensor(
        z_max + sigma * BG_NORMAL_MAX)))
    if mode == "blended":
        return (sigma ** 2 * z_max + sigma * (BG_NORMAL_MAX + f_max)
                + BG_ULPS * spacing), sigma, f_max
    f_inv = float(invs[0].out.double().abs()[out].max())
    return (2 * sigma ** 2 * z_max + sigma * (
        math.sqrt(sigma ** 2 + 1) * f_inv + f_max)
        + BG_ULPS * spacing), sigma, max(f_max, f_inv)


def background_reading(final, z, mask):
    """(max |final - z| outside the mask, mean |final - z| inside)."""
    diff = (final.double() - z.double()).abs()
    return float(diff[mask == 0].max()), float(diff[mask > 0].mean())


def phase_svd_sampling(torch, card, mode):
    """Main path 10's svd_test CLI with ``--sampling blended`` (and
    ``--dump_latents``) or ``--sampling inversion`` at main path 3's width
    on a synthetic gs/ tree (1 scene, 1 ctrl, mode x1): 14 finite frames, K4's launches, the resampling evaluations, the
    background check and its two planted faults; returns the launches of
    K4 and the CLI's output directories."""
    from PIL import Image

    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import edm
    from multiview_inpaint_tpu_torch.diffusion.engine import SVDEngine
    from multiview_inpaint_tpu_torch.pipelines import svd_test
    from multiview_inpaint_tpu_torch.utils import synthetic

    label = "15b" if mode == "blended" else "15c"
    work = os.path.join(REPO, "build", f"smoke_svd_{mode}")
    shutil.rmtree(work, ignore_errors=True)
    root, out_root = os.path.join(work, "gs"), os.path.join(work, "out")
    logdir, dump = os.path.join(work, "logs"), os.path.join(work, "latents")
    synthetic.write_gs_tree(root, scene="scene_case", ctrl="ctrl_0",
                            modes=("x1",), frames=SVD_FRAMES,
                            size=(SVD_H, SVD_W), iteration=30000)
    argv = ["--data_root", root, "--logdir", logdir, "--out", out_root,
            "--modes", "x1", "--num_frames", str(SVD_FRAMES), "--num_steps",
            str(SVD_STEPS), "--size", str(SVD_H), str(SVD_W), "--sampling",
            mode, "--device", DEVICE]
    if mode == "blended":
        argv += ["--dump_latents", dump]
    # The sampler's arguments and result, every resampling evaluation
    # (edm.denoise) and every inversion evaluation (edm.raw_net_out), of
    # the CLI's run and then of each planted fault's.
    with capture(svd_test, "init_engine", perturbed(torch, 7)), \
            capture(SVDEngine, f"sample_{mode}") as samples, \
            capture(edm, "denoise") as denoised, \
            capture(edm, "raw_net_out") as inverted:
        _kernels.reset_launches()
        svd_test.main(argv)
        launches = dict(_kernels.LAUNCHES)
        n_evals = len(denoised)
        (eng, cond, uc, z, mask), final = samples[0].args, samples[0].out
        bar, sigma, f_max = background_bar(torch, eng, mode, z, mask,
                                           denoised, inverted)
        # planted faults: the blend skipped (mask all ones), its mask
        # inverted
        faults = {}
        for name, fmask in (("blend skipped", torch.ones_like(mask)),
                            ("mask inverted", 1 - mask)):
            denoised.clear()
            inverted.clear()
            gen = torch.Generator(device=DEVICE).manual_seed(29)
            got = getattr(eng, f"sample_{mode}")(
                cond, uc, z, fmask, generator=gen, num_steps=BG_FAULT_STEPS)
            faults[name] = (background_reading(got, z, mask)[0],
                            background_bar(torch, eng, mode, z, mask,
                                           denoised, inverted)[0])
        del eng, samples
    out_dir = os.path.join(out_root, "scene_case", "ctrl_0", "x1")
    pngs = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    finite = []
    for p in pngs:
        with Image.open(os.path.join(out_dir, p)) as im:
            arr = np.asarray(im, np.float32)
        finite.append(arr.shape == (SVD_H, SVD_W, 3)
                      and bool(np.isfinite(arr).all()))
    checks = {}
    if mode == "blended":
        files = sorted(os.listdir(dump)) if os.path.isdir(dump) else []
        want = [f"latent_{i:03d}_blended.npy" for i in range(SVD_STEPS)]
        ladder = edm.edm_sigmas(SVD_STEPS).numpy()
        checks[f"{SVD_STEPS} dumps"] = files == want + ["latent_sigmas.npy"]
        checks["dumped sigmas = the run's sigma_hat ladder"] = (
            checks[f"{SVD_STEPS} dumps"] and np.array_equal(np.load(
                os.path.join(dump, "latent_sigmas.npy")), ladder))
        if checks[f"{SVD_STEPS} dumps"]:
            dumped = torch.from_numpy(np.load(os.path.join(dump, want[-1])))
            checks["last dump = the sampled latents"] = torch.equal(
                dumped, final.cpu())
            final = dumped
    evals = SVD_STEPS * (1 if mode == "blended" else 2)
    want_k4 = K4_PER_EVAL * evals
    reading, inside = background_reading(final.to(z.device), z, mask)
    checks.update({
        f"{SVD_FRAMES} frames written": len(pngs) == SVD_FRAMES,
        f"frames finite, {SVD_H}x{SVD_W}": bool(finite) and all(finite),
        f"K4 launched {want_k4} times": launches["flash_attn_fwd"]
        == want_k4,
        "no other kernel": sum(launches.values()) == launches[
            "flash_attn_fwd"],
        f"{SVD_STEPS} resampling evaluations": n_evals == SVD_STEPS,
        "background within its bar": reading <= bar,
        f"inside the mask >= {BG_INSIDE_FACTOR:g}x the bar":
            inside >= BG_INSIDE_FACTOR * bar,
        "planted faults fail the bar": all(r > b for r, b in
                                           faults.values())})
    fault_text = json.dumps({k: [float(f"{r:.4g}"), float(f"{b:.4g}")]
                             for k, (r, b) in faults.items()})
    print(f"[{label} main svd {mode}] svd_test --sampling {mode}"
          f"{' --dump_latents' if mode == 'blended' else ''}, {SVD_FRAMES} "
          f"frames at {SVD_H}x{SVD_W}, {SVD_STEPS} steps, {evals} "
          f"evaluations | background outside the latent mask: max |final - "
          f"z| {reading:.4g}, bar {bar:.4g} (sigma {sigma:.4g}, max|F| "
          f"{f_max:.4g}); inside: mean {inside:.4g} | planted faults "
          f"({BG_FAULT_STEPS} steps) reading / bar {fault_text}"
          f" | launches {launches} | {json.dumps(checks)} | {card}",
          flush=True)
    if not all(checks.values()):
        fail(f"main path 10 (svd_test --sampling {mode}) checks failed: "
             f"{checks}")
    return dict(launches=launches["flash_attn_fwd"], work=work,
                out_dir=out_dir,
                grid_dir=os.path.join(logdir, "log_img", "test"))


def phase_divide_test(card, runs):
    """The divide_test CLI on the grid each of phases 15b and 15c wrote:
    its frames equal the CLI's per-frame PNGs byte for byte, and the GIF
    preview holds x1 reversed without its first frame (13 frames)."""
    from multiview_inpaint_tpu_torch.pipelines import divide_test

    checks = {}
    for mode, rec in runs.items():
        out = os.path.join(rec["work"], "divided")
        divide_test.main(["--grid_dir", rec["grid_dir"], "--out", out,
                          "--items", "scene_case:ctrl_0:x1", "--frame_size",
                          str(SVD_H), str(SVD_W), "--num_frames",
                          str(SVD_FRAMES)])
        names = [f"{i:02d}.png" for i in range(SVD_FRAMES)]
        same = []
        for f in names:
            a = os.path.join(out, "scene_case", "ctrl_0", "x1", f)
            b = os.path.join(rec["out_dir"], f)
            with open(a, "rb") as fa, open(b, "rb") as fb:
                same.append(fa.read() == fb.read())
        from PIL import Image
        with Image.open(os.path.join(out, "vis_video", "scene_case",
                                     "ctrl_0.gif")) as im:
            n_gif = im.n_frames
        checks[mode] = dict(frames_equal=all(same),
                            gif_frames=n_gif == SVD_FRAMES - 1)
    print(f"[15e divide_test] the grids of 15b and 15c split into "
          f"{SVD_FRAMES} frames each, equal byte for byte to the CLI's "
          f"per-frame PNGs, GIF previews of {SVD_FRAMES - 1} frames: "
          f"{json.dumps(checks)} | {card}", flush=True)
    if not all(c["frames_equal"] and c["gif_frames"]
               for c in checks.values()):
        fail(f"divide_test checks failed: {checks}")


def _http(url, data=None):
    """(status, content type, body) of one request to the demo server."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data,
                                 method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _demo_image(path):
    """A seeded smooth 512x384 colour field written as a PNG."""
    from multiview_inpaint_tpu_torch.gs import scene_io
    rng = np.random.default_rng(31)
    yy, xx = np.meshgrid(np.linspace(0, 1, SVD_H), np.linspace(0, 1, SVD_W),
                         indexing="ij")
    c = rng.uniform(0.5, 3.0, (3, 2))
    img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (c[i, 0] * xx + c[i, 1]
                                                    * yy) + i)
                    for i in range(3)], -1)
    scene_io.save_image(path, img)
    with open(path, "rb") as f:
        return f.read()


def phase_demo_app(torch, card):
    """Main path 10's server: ``demo_app.make_server`` on port 0 with
    ``--device cuda`` at full width (2.94B random bf16 parameters made on
    the card, every all-zero one moved; the UNet held in f32), /health,
    the page, two POST /generate requests (the defaults, 25 steps and 14
    frames; another seed at DEMO_STEPS steps) answered with 14-frame GIFs
    that differ, K4 K4_PER_UNET_EVAL x steps times per request, the
    engine initialised once, a num_frames=3 request answered with 500;
    then one uncontrolled f32 denoiser evaluation (q and k x3) through K4
    against the plain attention and two planted faults, on the
    conditioning of the requests' first evaluation. Returns K4's launches
    per request."""
    import threading

    from PIL import Image

    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import (attention_op,
                                                       flash_attention)
    from multiview_inpaint_tpu_torch.diffusion.engine import SVDEngine
    from multiview_inpaint_tpu_torch.diffusion.transformer import (
        CrossAttention)
    from multiview_inpaint_tpu_torch.pipelines import demo_app
    from multiview_inpaint_tpu_torch.pipelines import (
        simple_video_sample as svs)

    work = os.path.join(REPO, "build", "smoke_demo")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    png = _demo_image(os.path.join(work, "input.png"))
    demo_app._MODEL.clear()
    srv = demo_app.make_server(demo_app.build_parser().parse_args(
        ["--port", "0", "--device", DEVICE]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    requests, gifs = [], []
    try:
        with capture(svs, "init_engine", perturbed(torch, 9)) as inits, \
                capture(SVDEngine, "apply_unet",
                        lambda a, kw, out: a[3]) as conds:
            health = _http(base + "/health")
            page = _http(base + "/")
            for query, steps in ((("seed=23", SVD_STEPS)),
                                 (f"seed=24&num_steps={DEMO_STEPS}",
                                  DEMO_STEPS)):
                _kernels.reset_launches()
                requests.append((steps, _http(base + "/generate?" + query,
                                              png),
                                 dict(_kernels.LAUNCHES)))
            bad = _http(base + "/generate?num_frames=3", png)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    answers = []
    for i, (steps, (code, ctype, body), launched) in enumerate(requests):
        frames = size = None
        if code == 200:
            path = os.path.join(work, f"out_{i}.gif")
            with open(path, "wb") as f:
                f.write(body)
            with Image.open(path) as im:
                frames, size = im.n_frames, im.size
        gifs.append(body)
        answers.append(dict(
            steps=steps, status=code, type=ctype, frames=frames, size=size,
            launches=launched["flash_attn_fwd"],
            other_launches=sum(launched.values())
            - launched["flash_attn_fwd"]))
    checks = {
        "health ok": health[0] == 200 and json.loads(health[2])["model"]
        == "svd",
        "page served": page[0] == 200 and b"Generate" in page[2],
        "200 and a 14-frame 512x384 GIF each": all(
            r["status"] == 200 and r["type"] == "image/gif"
            and r["frames"] == SVD_FRAMES and r["size"] == (SVD_W, SVD_H)
            for r in answers),
        "the two GIFs differ": len(set(gifs)) == 2,
        "engine initialised once": len(inits) == 1,
        f"K4 {K4_PER_UNET_EVAL} x steps per request, no other kernel": all(
            r["launches"] == K4_PER_UNET_EVAL * r["steps"]
            and r["other_launches"] == 0 for r in answers),
        "num_frames=3 answered with 500": bad[0] == 500,
    }
    print(f"[15f main demo_app] server on port {srv.server_address[1]}, "
          f"{sum(p.numel() for p in inits[0].parameters()) if inits else 0}"
          f" parameters made on the card at the first request | requests: "
          + "; ".join(f"{r['steps']} steps: {r['status']} {r['type']} "
                      f"{r['frames']} frames {r['size']} (K4 "
                      f"{r['launches']})" for r in answers)
          + f" | bad request {bad[0]}: {bad[2][:80]!r} | "
          f"{json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 10 (demo_app) checks failed: {checks}")

    eng, cfg = demo_app._MODEL["model"]
    cond = conds[0]
    del inits, conds
    with torch.no_grad():
        for m in eng.unet.modules():
            if isinstance(m, CrossAttention):
                m.to_q.weight.mul_(SVD_QK_GAIN)
                m.to_k.weight.mul_(SVD_QK_GAIN)
    dn = svs.uncontrolled_denoise_fn(eng, cfg)
    shape = (SVD_FRAMES, SVD_H // 8, SVD_W // 8, 4)
    sigma = torch.full((2 * SVD_FRAMES,), cfg.sigma_max, device=DEVICE)
    real = attention_op.flash_attention
    ref = flash_attention.flash_attention_ref

    def evaluate(seed, attend):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        x = torch.randn(shape, generator=gen, device=DEVICE) * float(
            (1 + cfg.sigma_max ** 2) ** 0.5)
        with patched(attention_op, "flash_attention", attend), \
                torch.no_grad():
            _kernels.reset_launches()
            out = dn(torch.cat([x, x]), sigma, cond)
        return out, _kernels.LAUNCHES["flash_attn_fwd"]

    out_k4, n_k4 = evaluate(11, real)
    out_plain, n_plain = evaluate(11, ref)
    out_drop, _ = evaluate(11, lambda q, k, v, h, sm: ref(
        q, k[:, FAULT_KEYS:], v[:, FAULT_KEYS:], h, sm))
    out_base, _ = evaluate(11, lambda q, k, v, h, sm: real(
        q, k, v, h, sm * math.log(2)))
    out_seed, _ = evaluate(12, real)
    err, drop, base = (_rms(o, out_plain) for o in (out_k4, out_drop,
                                                     out_base))
    seed_diff = _rms(out_seed, out_k4)
    bar = DEMO_EVAL_RMS_TOL
    print(f"[15f demo eval] one uncontrolled f32 denoiser evaluation at "
          f"sigma {cfg.sigma_max} (batch {2 * SVD_FRAMES}, UNet weights "
          f"{next(eng.unet.input_blocks.parameters()).dtype}), q and k x"
          f"{SVD_QK_GAIN}: K4 launches {n_k4} (on "
          f"{cond['concat'].dtype} operands), with attention_op's K4 call "
          f"patched to the plain version {n_plain} | relative rms diff "
          f"from the plain-attention output: K4 {err:.4g}, bar {bar}; "
          f"planted faults: first key tile dropped {drop:.4g}, softmax "
          f"base 2 {base:.4g} | another noise seed moves it by "
          f"{seed_diff:.4g} (bar at most a tenth: {bar <= seed_diff / 10})"
          f" | all finite: {bool(torch.isfinite(out_k4).all())} | {card}",
          flush=True)
    demo_app._MODEL.clear()
    del eng, cond, dn
    if not (n_k4 == K4_PER_UNET_EVAL and n_plain == 0 and err <= bar
            and bar < min(drop, base) and bar <= seed_diff / 10
            and torch.isfinite(out_k4).all()):
        fail("the f32 uncontrolled denoiser through K4 disagrees with the "
             "plain attention, or the bar does not separate the planted "
             "faults")
    return [r["launches"] for r in answers]


def _rms(a, b):
    """Relative rms of a - b against b (f32)."""
    a, b = a.float(), b.float()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def phase_k5(torch, card):
    """K5 against its plain version on packed [B, T, H*D] inputs at main
    path 4's shapes, o and the logsumexp from K4, a seeded cotangent; the
    bf16 shapes, ds1 and ds2, also timed beside their bound. Returns the
    record of the ds1 shape for the kernels line (launches filled in
    later). The launches made here are taken off the counters again."""
    import torch.nn.functional as F

    from port_bench.counts import peaks
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
        note = ""
        if dtype == "bfloat16":
            flop = 10 * b * h * t * t * d
            t_ops = max(flop / peaks.BF16_FLOP_PER_S,
                        b * h * t * t / peaks.SFU_OP_PER_S)
            t_bytes = (7 * q.numel() * q.element_size()
                       + 2 * lse.numel() * 4) / peaks.HBM_BYTES_PER_S
            qh, kh, vh = (x.view(b, t, h, d).transpose(1, 2).detach()
                          .requires_grad_() for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            doh = do.view(b, t, h, d).transpose(1, 2)
            rec = timed(torch, lambda: fa.flash_attention_bwd(*args),
                        lambda: fa.flash_attention_bwd_ref(*args), 10, 2,
                        max(t_ops, t_bytes),
                        "operations" if t_ops >= t_bytes else "bytes",
                        library=lambda: torch.autograd.grad(
                            lib_out, (qh, kh, vh), doh, retain_graph=True),
                        max_abs_err=err)
            del lib_out
            records.append(rec)
            note = (f" | {timing_note(rec)}, "
                    f"{flop / rec['ms'] / 1e9:.1f} TFLOP/s")
        print(f"[16 K5 {dtype} [{b}, {t}, {h}*{d}], {h} heads] dq/dk/dv max "
              f"abs err {err:.4g}, / max|plain| {rel:.4g} (bar "
              f"{K5_REL_TOL}), relative rms {rms:.4g} (bar {K5_RMS_TOL}) | "
              f"bit-equal on a second run: {equal}, finite: {finite}{note} "
              f"| {card}", flush=True)
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
        with patched(flash_attention, "FlashAttention", fn):
            _kernels.reset_launches()
            xi = x.detach().requires_grad_()
            out = block(xi, ctx, SVD_FRAMES, ind)
            g = torch.autograd.grad((out.float() * cot).sum(),
                                    [xi] + params)
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
    """Main path 4: the svd_train CLI at full width (its steps through
    ``make_dp_train_step`` without a process group) under the spans;
    returns its launch counts and its engine."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import checkpoint as ckpt
    from multiview_inpaint_tpu_torch.parallel import svd_data_parallel as dp
    from multiview_inpaint_tpu_torch.pipelines import svd_train
    from multiview_inpaint_tpu_torch.utils import synthetic

    work = os.path.join(REPO, "build", "smoke_svd_train")
    shutil.rmtree(work, ignore_errors=True)
    root, logdir = os.path.join(work, "est"), os.path.join(work, "logs")
    synthetic.write_est_tree(root, scenes=TRAIN_SVD_SCENES,
                             frames=SVD_FRAMES, size=(SVD_H, SVD_W))

    def init(args, kw, eng):
        """The new engine with its all-zero parameters moved, and its
        frozen networks' fingerprints and ControlNet before training."""
        perturb_zero_params(torch, eng, 27)
        frozen = {n: _fingerprints(torch, getattr(eng, n))
                  for n in ("unet", "vae", "clip")}
        return eng, frozen, {k: p.detach().clone()
                             for k, p in eng.controlnet.named_parameters()}

    # The EMA is the dict each step updates in place.
    _kernels.reset_launches()
    with capture(svd_train, "init_engine", init) as inits, \
            capture(dp, "ema_update", lambda a, kw, out: a[0]) as emas, \
            spans("19 main svd train") as sp:
        svd_train.main(["--data_root", root, "--logdir", logdir,
                        "--epochs", "1", "--num_frames", str(SVD_FRAMES),
                        "--size", str(SVD_H), str(SVD_W), "--ckpt_every",
                        "1", "--log_interval", "1", "--ema", "--device",
                        DEVICE])
    launches = dict(_kernels.LAUNCHES)
    (eng, frozen, cn0), = inits
    steps = sp.get("engine.eval", {}).get("count", 0)   # one per step
    with open(os.path.join(logdir, "svd_train_log.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    frozen_same = {n: _fingerprints(torch, getattr(eng, n)) == frozen[n]
                   for n in ("unet", "vae", "clip")}
    cn_moved = sum(int((p.detach() != cn0[k]).sum())
                   for k, p in eng.controlnet.named_parameters())
    cn_total = sum(p.numel() for p in eng.controlnet.parameters())
    path = os.path.join(logdir, "checkpoints", "epoch=000000.npz")
    ema = emas[-1] if emas else {}
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
        "EMA updated every step": len(emas) == steps and all(
            e is emas[0] for e in emas),
        "checkpoint written and read back": read_back,
    }
    print(f"[19 main svd train] svd_train CLI, "
          f"{sum(p.numel() for p in eng.parameters())} parameters (bf16; the "
          f"VAE f32; all-zero tensors moved), {TRAIN_SVD_SCENES} scenes of "
          f"{SVD_FRAMES} frames at {SVD_H}x{SVD_W}, 1 epoch at batch 1, "
          f"--ema, remat none | losses {[round(x, 4) for x in losses]} | "
          f"ControlNet entries changed by the run {cn_moved / cn_total:.4f} "
          f"of {cn_total} | launches {launches} | {json.dumps(checks)} | "
          f"{card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 4 (svd_train CLI) checks failed: {checks}")
    return launches, eng


def _type_spacing(torch, x):
    """The spacing of numbers of x's type at each entry of ``x``."""
    e = torch.frexp(x.float()).exponent
    return torch.ldexp(torch.full_like(x, torch.finfo(x.dtype).eps,
                                       dtype=torch.float32), e - 1)


def phase_ddp_step(torch, card, eng):
    """Main path 12 (c), on main path 4's engine: DDP_STEPS
    ``make_dp_train_step`` steps with the EMA (decay 0.9999) over NCCL at
    world size 1 against DDP_STEPS ``make_train_step`` steps, both from
    the same trainable parameters with draws from generators of one seed,
    on one synthetic video at main path 4's shapes (bars at
    FS_FORWARD_RMS_TOL's comment); the flat all-reduce buffers' bytes per
    type, counters zeroed before the DDP steps. Returns their launches."""
    import torch.distributed as dist

    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.parallel import mesh
    from multiview_inpaint_tpu_torch.parallel import svd_data_parallel as dp

    with torch.no_grad():
        c = eng.prepare_cond(_svd_batch(torch, SVD_FRAMES, SVD_H, SVD_W,
                                        DEVICE, 41))
    cond_b = {k: v[None] for k, v in c.items()}
    lat = torch.randn((1, SVD_FRAMES, SVD_H // 8, SVD_W // 8, 4),
                      generator=torch.Generator(device=DEVICE).manual_seed(
                          42), device=DEVICE)
    params = dp.trainable_params(eng)
    p0 = {k: p.detach().clone() for k, p in params.items()}

    def run(make):
        dp.apply_trainable(params, p0)
        opt = dp.build_optimizer(DDP_LR)
        state = opt.init(params)
        ema = {k: p.detach().clone() for k, p in params.items()}
        step = make(eng, opt, params, 0.9999)
        gen = torch.Generator(device=DEVICE).manual_seed(43)
        losses = [float(step(state, ema, lat, cond_b, generator=gen))
                  for _ in range(DDP_STEPS)]
        return dict(losses=losses, mu=state["mu"], ema=ema,
                    params={k: p.detach().clone() for k, p in params.items()})

    ref = run(dp.make_train_step)
    mesh.init(0, 1, f"tcp://127.0.0.1:{_free_port()}", DEVICE)
    try:
        backend = dist.get_backend()
        _kernels.reset_launches()
        got = run(dp.make_dp_train_step)
        launches = dict(_kernels.LAUNCHES)
    finally:
        dist.destroy_process_group()
    flat = {}
    for p in params.values():
        flat[str(p.dtype)] = flat.get(str(p.dtype), 0) + p.numel() * \
            p.element_size()
    worst, small, differ, total = 0.0, 0, 0, 0
    for k in ref["mu"]:
        big = ref["mu"][k].abs() >= 1e-7
        for what in ("params", "ema"):
            a, b = got[what][k], ref[what][k]
            r = ((a.float() - b.float()).abs() / _type_spacing(torch, b))
            worst = max(worst, float(r[big].max()) if big.any() else 0.0)
            differ += int((a != b).sum())
        small += int((~big).sum())
        total += big.numel()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                       ref["losses"]))
    want_k5, want_k4 = (K5_PER_STEP * DDP_STEPS,
                        K4_PER_TRAIN_STEP * DDP_STEPS)
    checks = {
        "nccl": backend == "nccl",
        f"losses within {DDP_LOSS_REL_TOL}": loss_rel <= DDP_LOSS_REL_TOL,
        "params and EMA within one spacing": worst <= 1.0,
        "finite": all(math.isfinite(x) for x in got["losses"]),
        f"K5 launched {want_k5} times": launches["flash_attn_bwd"] == want_k5,
        f"K4 launched {want_k4} times": launches["flash_attn_fwd"] == want_k4,
    }
    print(f"[19a ddp step] {backend} at world size 1 on main path 4's "
          f"engine, {DDP_STEPS} steps of one video ({SVD_FRAMES} frames at "
          f"{SVD_H}x{SVD_W}), EMA 0.9999, lr {DDP_LR}: make_dp_train_step "
          f"against make_train_step, losses "
          f"{got['losses']} against {ref['losses']} (worst rel "
          f"{loss_rel:.3g}) | params and EMA: worst difference "
          f"{worst:.3g} spacings where |mu| >= 1e-7, {differ} entries "
          f"differ at all, {small} of {total} entries below counted | flat "
          f"all-reduce buffers (bytes per type) {json.dumps(flat)} | "
          f"launches {launches} | "
          f"{json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 12 (the DDP step) checks failed: {checks}")
    return launches


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
    """n gradient-free renders: K1, K2 and K6 n times each."""
    return {"pair_expand": n, "composite": n, "composite_bwd": 0,
            "flash_attn_fwd": 0, "flash_attn_bwd": 0, "project": n,
            "project_bwd": 0}


def phase_gen_seq(torch, card, s):
    """Main path 5: the gen_seq CLI on big2m under the spans. Returns its
    launch counts."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.gs import obb
    from multiview_inpaint_tpu_torch.pipelines import gen_seq

    _kernels.reset_launches()
    with spans("21 main gen_seq") as sp:
        gen_seq.main(_stage1_argv(s))
    launches = dict(_kernels.LAUNCHES)
    n_train = len(YAWS)
    want = len(SEQ_MODES) * SEQ_FRAMES + n_train

    def seq(mode):
        return os.path.join(s["ws"], "inpaint", "seq", s["sid"], mode,
                            "ours_1")

    center = obb.load_obb(s["box"]).center
    checks = {f"K1, K2 and K6 launched {want} times, K3-K5 0":
              launches == _forward_launches(want),
              f"{want} renders": sp.get("render", {}).get("count") == want}
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

    print(f"[21 main gen_seq] gen_seq CLI, {BIG_N} gaussians, modes "
          f"{list(SEQ_MODES)} x {SEQ_FRAMES} frames at {ORBIT_H}x{ORBIT_W} "
          f"(HxW) + {n_train} bds_train views at 1920x1080 (PNGs written) | "
          f"launches {launches} | mask cover per frame {json.dumps(cover)} "
          f"| {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 5 (gen_seq CLI) checks failed: {checks}")
    return launches


def _render_route(torch, params, cam, k2=None):
    """``api.render`` of ``cam`` with its K2 call replaced by ``k2``
    (None: K2 itself), which takes the call's arguments and its band
    keywords ``row0`` and ``stride``."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import api
    with (patched(api, "composite_tiles", k2) if k2
          else contextlib.nullcontext()), torch.no_grad():
        return api.render(params, cam, torch.zeros(3, device=DEVICE),
                          device=DEVICE)


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

    def plain_k2(*a, **band):
        return composite.composite_segments(*a, **band)

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

    def faulty_k2(*a, **band):
        t8 = real_k2(*a, **band).clone()
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
        main(_stage1_argv(s) + extra)
        launches = dict(_kernels.LAUNCHES)
        pngs = [os.path.join(d, n) for d in dirs
                for n in sorted(os.listdir(d))]
        arrs = [_png_array(p) for p in pngs]
        checks = {f"K1, K2 and K6 launched {want} times, K3-K5 0":
                  launches == _forward_launches(want),
                  f"{want} PNGs at {shape}": len(arrs) == want and all(
                      a.shape == shape for a in arrs),
                  "no constant PNG": all(a.std() > 0 for a in arrs)}
        print(f"[23 {name}] {name} CLI, {BIG_N} gaussians, {want} frames at "
              f"{ORBIT_H}x{ORBIT_W} (PNGs written) | launches {launches} | "
              f"{json.dumps(checks)} | {card}", flush=True)
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
    delete.main(["-m", s["model"], "--box", s["del_box"], "--iteration", "1",
                 "--device", DEVICE])
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
    gen_pc.main(["-m", s["model"], "--iteration", "1"])
    pts, _, _ = ply_io.fetch_point_cloud(os.path.join(s["model"], "xyz.ply"))
    checks = {"removed > 0": removed > 0,
              "removed = contains on CUDA": removed == int(in_cuda.sum()),
              "none left inside": left == 0,
              "contains CUDA = CPU off fragile rows":
              not bool((differ & ~fragile).any()),
              "gen_pc wrote 10000 points": len(pts) == 10000}
    print(f"[24 delete, gen_pc] delete CLI on {len(xyz)} gaussians: "
          f"{removed} removed, {left} left inside | contains CUDA vs CPU: "
          f"{int(differ.sum())} rows differ, {int(fragile.sum())} within "
          f"{obb.FRAGILE_TOL} of a face | gen_pc CLI, {len(pts)} points | "
          f"{json.dumps(checks)} | {card}", flush=True)
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
    visible, fov = {}, None
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
            with torch.no_grad():
                img = render(both, cam, black, device=DEVICE).rgb
                o = render(alone, cam, black, device=DEVICE)
                b = render(big, cam, black, device=DEVICE)
            a = o.alpha.clamp(min=1e-6)
            d_obj = (o.depth - (1 - o.alpha) * DEPTH_EMPTY) / a
            visible[(mode, i)] = ((o.alpha > 0.5) & (d_obj < b.depth)
                                  ).cpu().numpy()
            scene_io.save_image(os.path.join(out_dir, f"{i:02d}.png"),
                                img.cpu().numpy())
    cover = [round(float(v.mean()), 4) for v in visible.values()]
    print(f"[25 stage-2 frames] big2m + a {OBJECT_N}-splat object of colour "
          f"{OBJECT_RGB} (spread {OBJECT_SPREAD}, scale {OBJECT_SCALE}, "
          f"opacity {OBJECT_OPACITY}) at the insertion box centre, rendered "
          f"together at {len(visible)} orbit poses ({ORBIT_H}x{ORBIT_W}) "
          f"into ctrl 0's inpainted frames | visible object cover per frame "
          f"{cover} | {card}", flush=True)
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

    seg_masks.main(["--scene_id", s["sid"], "--ctrl_id", "0", "--modes",
                    *SEQ_MODES, "--frames", str(SEQ_FRAMES), "--iteration",
                    "1", "--workspace", s["ws"], "--auto", "--propagate",
                    "--fovx", repr(fov[0]), "--fovy", repr(fov[1]),
                    "--device", DEVICE])

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
          f"{list(SEQ_MODES)} x {SEQ_FRAMES} frames | IoU against the "
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
    card at GROUND_WINDOWS."""
    import copy

    from multiview_inpaint_tpu_torch.diffusion import checkpoint
    from multiview_inpaint_tpu_torch.gs import scene_io
    from multiview_inpaint_tpu_torch.guidance import grounding
    from multiview_inpaint_tpu_torch.pipelines import seg_masks

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
    seg_masks.main(argv + ["--ground", GROUND_QUERY, "--clip_ckpt", npz,
                           "--bpe_vocab", merges])
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
    checks = {f"{len(wins)} windows at {ORBIT_H}x{ORBIT_W}": len(wins) == 57,
              "grounded masks within the auto masks": subset,
              f"f32 scores within {GROUND_REL_TOL} of max|f64|":
              rel <= GROUND_REL_TOL}
    print(f"[27 seg_masks ground] towers {n_params / 1e9:.3f}B f32 "
          f"parameters (ViT-H/14 + 23-layer text), npz of "
          f"{os.path.getsize(npz) / 2**30:.2f} GiB | seg_masks --ground "
          f"{GROUND_QUERY!r} on x1: share of the auto mask kept per frame "
          f"{kept} | frame 0 scores "
          f"f32 vs f64 at windows {list(GROUND_WINDOWS)}: f64 "
          f"{[round(float(v), 5) for v in s64]}, max abs err "
          f"{float(err.max()):.3g}, relative to max|f64| {rel:.3g} (bar "
          f"{GROUND_REL_TOL}); best window {wins[int(np.argmax(s32))].tolist()}"
          f" | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 6 (seg_masks --ground) checks failed: {checks}")


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
    before the CLI: a 512x384 seq view with the full
    loss and a 1080p training view with the background loss, K3 held
    against the plain K3 (``check_k3``), K1 and K2 against theirs
    (``k2_with_state``), the pairs whose K3 rows are all zero and the
    pixels whose cotangent is; returns the densification threshold."""
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
    params = scene_mod.load_sd_ply(del_ply, obb.load_obb(s["box"]),
                                   n_samples=REC_SAMPLES, device=DEVICE)
    n_rows = int(params.num_live())
    state = gs_trainer.init_state(params)
    cfg = gs_trainer.OptimizationConfig()
    bg = torch.zeros(3, device=DEVICE)
    threshold = None
    for kind, cam in (("seq", next(c for c in cams if c.inpainted)),
                      ("train_1080p", next(c for c in cams
                                           if not c.inpainted))):
        mode = "full" if cam.inpainted else "background"
        gt = torch.as_tensor(np.asarray(cam.image, np.float32),
                             device=DEVICE)
        mask = (None if cam.inpainted else torch.as_tensor(
            np.asarray(cam.mask, np.float32), device=DEVICE))
        label = f"28 {kind} {cam.width}x{cam.height} {mode}"
        (state, m), k1_args, k3_args, gid = kernel_inputs(
            lambda: gs_trainer.train_step(
                state, RenderCamera.from_camera(cam, DEVICE), gt, bg,
                cfg, sc.cameras_extent, 0, mask, mode))
        check_k3(torch, card, f"{label} K3", k3_args, gid,
                 state.params.capacity)
        k2_with_state(torch, card, k1_args, k3_args, "28",
                      f"orbit-rec {kind}")
        with torch.no_grad():
            d_k = composite_cuda.composite_bwd(*k3_args)
        zero_rows = int((d_k[:, :10] == 0).all(dim=1).sum())
        g = k3_args[4]
        zero_px = float((g[:, :5] == 0).all(dim=1).float().mean())
        print(f"[{label}] {n_rows} rows in {state.params.capacity}, pairs "
              f"{m.pairs}, loss {float(m.loss):.5f}, non-finite gradients "
              f"{int(m.nonfinite_grads)} | pairs with all-zero K3 rows "
              f"{zero_rows} of {d_k.shape[0]} ({zero_rows / d_k.shape[0]:.4f})"
              f", tile pixels with a zero cotangent {zero_px:.4f} | {card}",
              flush=True)
        if int(m.nonfinite_grads) or not torch.isfinite(m.loss):
            fail(f"main path 6 step {label}: non-finite loss or gradients")
        if threshold is None:
            seen = state.stats.denom > 0
            threshold = float(torch.quantile(
                state.stats.grad_accum[seen][:2**24], REC_DENSIFY_QUANTILE))
        del k1_args, k3_args, gid, d_k, g
    checks = {f"{REC_CAMERAS} cameras per epoch": len(cams) == REC_CAMERAS,
              "27 of them seq views": n_seq == 27,
              f"the del PLY's {n_del} rows + {REC_SAMPLES}":
              n_rows == n_del + REC_SAMPLES}
    print(f"[28 stage-2 steps] {json.dumps(checks)} | densify threshold "
          f"{threshold:.4g} (the {REC_DENSIFY_QUANTILE} quantile of the seq "
          f"step) | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 6 (stage-2 steps) checks failed: {checks}")
    del state, params
    torch.cuda.empty_cache()
    return threshold


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
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from multiview_inpaint_tpu_torch.pipelines import inpaint_rec

    out = os.path.join(s["work"], "output_rec", s["sid"])
    shutil.rmtree(out, ignore_errors=True)
    first, until, every = REC_DENSIFY
    _kernels.reset_launches()
    # each step's loss mode, image height and loss
    with capture(gs_trainer, "train_step", lambda a, kw, out: (
            kw.get("loss_mode", "full"), a[2].shape[0], out[1].loss)) as steps:
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
    launches = dict(_kernels.LAUNCHES)
    losses = {}
    for mode, h, loss in steps:
        losses.setdefault((mode, h), []).append(float(loss))
    seq_loss = losses.get(("full", ORBIT_H), [])
    bg_h = next((h for mode, h in losses if mode == "background"), 0)
    bg_loss = losses.get(("background", bg_h), [])
    with open(os.path.join(out, "ctrl_0", "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    logged = [r for r in log if "loss" in r]
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
        "K1, K2, K3, K6, K7 once per step": launches == {
            "pair_expand": REC_ITERS, "composite": REC_ITERS,
            "composite_bwd": REC_ITERS, "flash_attn_fwd": 0,
            "flash_attn_bwd": 0, "project": REC_ITERS,
            "project_bwd": REC_ITERS},
        "every step captured": len(steps) == REC_ITERS,
        "seq views' loss falls (first vs last 20)": loss_last < loss_first,
        f"densify ran at {list(range(first, until, every))}":
        [r["step"] for r in densified] == list(range(first, until, every)),
        "densify wrote rows": bool(densified) and sum(
            r["cloned"] + r["split"] for r in densified) > 0,
        "no non-finite gradient": all(r["nonfinite_grads"] == 0
                                      for r in logged),
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
          f"height {bg_h}) from load_sd_ply's rows | launches {launches} | "
          f"seq steps {len(seq_loss)}, loss first/last {n} "
          f"{loss_first:.5f} -> {loss_last:.5f}; background steps "
          f"{len(bg_loss)} | densify {densify} | points "
          f"{logged[-1]['points'] if logged else None} | masked PSNR in the "
          f"SAM masks {psnr0:.3f} -> {psnr1:.3f} dB | {json.dumps(checks)} "
          f"| {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 6 (inpaint_rec CLI) checks failed: {checks}")
    return launches


def _write_ckpt(torch, path, modules):
    """``torch.save`` of ``{"state_dict": ...}`` with each module's state
    under its prefix (``modules``: (prefix, module) pairs), the tensors
    copied to the host."""
    sd = {pre + k: v.detach().cpu() for pre, m in modules
          for k, v in m.state_dict().items()}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"state_dict": sd}, path)


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
    returns them."""
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
    _write_ckpt(torch, sw["sd"], (
        (checkpoint.PREFIXES["unet"], unet), (checkpoint.PREFIXES["vae"],
                                              vae)))
    del unet, vae
    torch.cuda.empty_cache()
    np.save(sw["embs"], _text_embs(1024, 72))
    sw["guidance"] = sds_train.build_guidance(argparse.Namespace(
        sd_ckpt=sw["sd"], guidance_scale=SDS_GUIDANCE), DEVICE)
    sw["text"] = torch.as_tensor(np.load(sw["embs"]), device=DEVICE)
    print(f"[30 slice-7 setup] SD-2-inpainting-width UNet2D (UNet2DConfig()) "
          f"+ 2D VAE: {n_params} random f32 parameters, all-zero ones moved,"
          f" written as {os.path.getsize(sw['sd']) / 2**30:.2f} GiB .ckpt, "
          f"read into the SDS prior (build_guidance) | text embeddings "
          f"[2, 77, 1024] from the seed "
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
        with patched(attention_op, "flash_attention", attend), \
                torch.no_grad():
            _kernels.reset_launches()
            out = unet(x, t, sw["text"])
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
    after a warm-up step on it: K3 against its plain
    version under the step's own cotangent (``check_k3``), K1 and K2
    against theirs with the per-item state (``k2_with_state``), the SDS
    image gradient (a hook on the image the prior's ``vae_encode`` takes
    with a gradient) finite and non-zero inside the mask, the launches of
    the step; returns the densification threshold."""
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
    img_grads = []

    def hook(a, kw_, out):
        if a[0].requires_grad:
            a[0].register_hook(lambda g: img_grads.append(g.detach()))

    label = f"32 sds step {cam.width}x{cam.height}"
    _kernels.reset_launches()
    with capture(sw["guidance"], "vae_encode", hook):
        (state, m), k1_args, k3_args, gid = kernel_inputs(
            lambda: sds_trainer.sds_train_step(state, *args, **kw))
    launches = dict(_kernels.LAUNCHES)
    g = img_grads[-1][0]
    inside = resize_nearest(mask, (SDS_SIZE, SDS_SIZE)) > 0.5
    g_in = g.abs().amax(dim=-1)[inside]
    check_k3(torch, card, f"{label} K3", k3_args, gid,
             state.params.capacity)
    k2_with_state(torch, card, k1_args, k3_args, "32", "orbit-sds 1080p")
    seen = state.stats.denom > 0
    threshold = float(torch.quantile(state.stats.grad_accum[seen][:2**24],
                                     REC_DENSIFY_QUANTILE))
    checks = {
        f"{len(YAWS)} SDS cameras (bds_train views with box masks)":
        len(cams) == len(YAWS),
        "K1, K2, K3, K6, K7 once, K4 10 times, K5 never":
        launches == {"pair_expand": 1, "composite": 1, "composite_bwd": 1,
                     "flash_attn_fwd": K4_PER_UNET2D_EVAL,
                     "flash_attn_bwd": 0, "project": 1, "project_bwd": 1},
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
          f"{float((g_in > 0).float().mean()):.4f} | densify threshold "
          f"{threshold:.4g} (the {REC_DENSIFY_QUANTILE} quantile) | "
          f"{json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 7 (SDS step) checks failed: {checks}")
    del state, params, k1_args, k3_args, gid
    torch.cuda.empty_cache()
    return threshold


def phase_sds_train(torch, card, s, sw, threshold):
    """Main path 7: the sds_train CLI (SDS_ITERS steps on the SDS
    cameras, the prior from the .ckpt), counters zeroed before and read
    after: K1-K3 once and K4 10 times per step, K5 never; the background
    loss of the 20 steps before the densification at step 50 below the
    first 20's (the split right after it repaints the background for
    the next steps), finite after it; densify ran at step 50 and wrote
    rows; no non-finite gradient; the PLY written and loaded; the run
    under the spans. Returns the launches and the model dir."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.gs import gaussians
    from multiview_inpaint_tpu_torch.pipelines import sds_train

    out = os.path.join(s["work"], "output_sds", s["sid"])
    shutil.rmtree(out, ignore_errors=True)
    _kernels.reset_launches()
    with spans("33 main sds_train") as sp:
        sds_train.main([
            "-s", s["src"], "-m", out, "--scene_id", s["sid"],
            "--bg_model", s["model"], "--bg_iteration", "1", "--workspace",
            s["ws"], "--registry", s["registry"], "--resolution", "1",
            "--n_samples", str(REC_SAMPLES), "--iterations", str(SDS_ITERS),
            "--save_iterations", str(SDS_ITERS), "--sd_ckpt", sw["sd"],
            "--text_embs", sw["embs"], "--densify_grad_threshold",
            repr(threshold), "--log_interval", "1", "--device", DEVICE])
    launches = dict(_kernels.LAUNCHES)
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
        "K1-K3, K6, K7 once, K4 10 times per step, K5 never": launches == {
            "pair_expand": SDS_ITERS, "composite": SDS_ITERS,
            "composite_bwd": SDS_ITERS,
            "flash_attn_fwd": K4_PER_UNET2D_EVAL * SDS_ITERS,
            "flash_attn_bwd": 0, "project": SDS_ITERS,
            "project_bwd": SDS_ITERS},
        "every step logged": len(steps) == SDS_ITERS
        == sp.get("sds.step", {}).get("count"),
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
          f"prior from the .ckpt | launches {launches} | "
          f"background loss steps 1-{n} {statistics.mean(bg[:n]):.6f}, "
          f"{SDS_DENSIFY - n + 1}-{SDS_DENSIFY} "
          f"{statistics.mean(bg[SDS_DENSIFY - n:SDS_DENSIFY]):.6f}, after "
          f"the densification {statistics.mean(bg[SDS_DENSIFY:]):.6f} (by "
          f"10 steps {windows}), SDS term median "
          f"{statistics.median(r['sds'] for r in steps) * SDS_WEIGHT:.5g} "
          f"(SDS loss x {SDS_WEIGHT}) | densify {densify} | points "
          f"{steps[-1]['points']} | {json.dumps(checks)} | {card}",
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
    launches = {}

    def run(name, main, argv):
        _kernels.reset_launches()
        main(argv)
        launches[name] = dict(_kernels.LAUNCHES)

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
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               dpt_path)
    del model
    depth_argv = common + ["-m", s["model"], "--sds_model", sds_out,
                           "--sds_iteration", str(SDS_ITERS)]
    with capture(dpt, "estimate_depth", lambda a, kw, out: None) as dpt_runs:
        run("gen_depth --dpt_ckpt", gen_depth.main, depth_argv
            + ["--dpt_ckpt", dpt_path])
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
                view, DEVICE),
                lambda *a, **band: composite.composite_segments(*a, **band))
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
        "DPT run on every frame": len(dpt_runs) == n,
        f"gen_seq --sds: K1, K2, K6 {n} times": launches["gen_seq --sds"]
        == _forward_launches(n),
        "gen_seq --sds renders not constant": seq_varied,
        f"gen_depth --dpt_ckpt: K1, K2, K6 {n} times": launches[
            "gen_depth --dpt_ckpt"] == _forward_launches(n),
        "DPT depth PNGs not constant": dpt_varied,
        f"gen_depth: K1, K2, K6 {n} times": launches["gen_depth"]
        == _forward_launches(n),
        f"disparity equal to the plain K2 route's on all but "
        f"{BAD_FRACTION} of pixels, by at most 1 level": frames == n and (
            differ <= BAD_FRACTION * pixels and worst <= 1),
    }
    print(f"[34 main gen_seq --sds, gen_depth] gen_seq --sds on the "
          f"sds_train PLY ({int(params.num_live())} rows); gen_depth "
          f"--dpt_ckpt (random DPT-large, DPTConfig(), "
          f"{os.path.getsize(dpt_path) / 2**30:.2f} GiB) on {n} frames; "
          f"gen_depth (rendered disparity) | disparity vs "
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
    kernel; the PNGs written and not constant."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import checkpoint
    from multiview_inpaint_tpu_torch.diffusion.unet2d import UNet2DConfig
    from multiview_inpaint_tpu_torch.pipelines import ctrl_inpaint

    cfg = UNet2DConfig(context_dim=CTRL_CONTEXT)
    paths = dict(sd=os.path.join(sw["work"], "sd15_inpaint.ckpt"),
                 ctrl=os.path.join(sw["work"], "control_depth.ckpt"),
                 embs=os.path.join(sw["work"], "embs_768.npy"))
    unet = _random_prior(torch, cfg, 74)
    vae = _random_vae(torch, 75)
    _write_ckpt(torch, paths["sd"], (
        (checkpoint.PREFIXES["unet"], unet), (checkpoint.PREFIXES["vae"],
                                              vae)))
    del unet, vae
    cnet = _random_prior(torch, cfg, 76, controlnet=True)
    _write_ckpt(torch, paths["ctrl"], (
        (checkpoint.PREFIXES["controlnet"], cnet),))
    del cnet
    torch.cuda.empty_cache()
    np.save(paths["embs"], _text_embs(CTRL_CONTEXT, 77))
    out_dir = os.path.join(s["ws"], "inpaint", "ctrl", s["sid"])
    runs = {}
    for sampler, n_samples in (("unipc", 2), ("dpmpp2m", 1)):
        shutil.rmtree(out_dir, ignore_errors=True)
        _kernels.reset_launches()
        ctrl_inpaint.main([
            "--scene_id", s["sid"], "--workspace", s["ws"],
            "--sd_ckpt", paths["sd"], "--ctrl_ckpt", paths["ctrl"],
            "--text_embs", paths["embs"], "--context_dim",
            str(CTRL_CONTEXT), "--size", str(SDS_SIZE), "--iteration",
            "1", "--n_samples", str(n_samples), "--num_steps",
            str(CTRL_STEPS), "--sampler", sampler, "--device", DEVICE])
        pngs = [os.path.join(out_dir, f"ctrl_{i}.png")
                for i in range(n_samples)]
        arrs, varied = _png_stats(pngs)
        runs[sampler] = dict(
            launches=dict(_kernels.LAUNCHES),
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
            "flash_attn_fwd": k4, "flash_attn_bwd": 0, "project": 0,
            "project_bwd": 0}
        checks[f"{sampler}: {r['n']} PNGs at {SDS_SIZE}^2, not constant"] = \
            r["ok"]
    print(f"[35 main ctrl_inpaint] ctrl_inpaint CLI at full width "
          f"(UNet2DConfig(context_dim={CTRL_CONTEXT}) + ControlNet2D + 2D "
          f"VAE, "
          f"random, all-zero parameters moved), --size {SDS_SIZE}, "
          f"{CTRL_STEPS} steps, CFG batch 2 | "
          + " | ".join(f"{k}: {r['n']} samples, launches {r['launches']}"
                       for k, r in runs.items())
          + f" | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 7 (ctrl_inpaint CLI) checks failed: {checks}")
    return {k: r["launches"] for k, r in runs.items()}


def _rec_ply(s):
    """Main path 6's recomposed PLY (the ``inpaint_rec`` CLI's output)."""
    return os.path.join(s["work"], "output_rec", s["sid"], "ctrl_0",
                        "point_cloud", f"iteration_{REC_ITERS}",
                        "point_cloud.ply")


def phase_cmp_render(torch, card, s):
    """Main path 8, its renders: the ``render`` CLI on main path 6's
    recomposed PLY and on main path 5's source PLY at the CMP_YAWS views
    of the bench COLMAP scene (1920x1080), counters zeroed before each
    run: K1 and K2 once per view, K3-K5 never; the frames moved into the
    layout ``cmp`` reads, ``vis/cmp/<exp>/{inpainted,src}/<scene>/
    ours_<iter>/renders`` (the inpainted scene is ``<scene>_<case>``,
    whose source ``cmp`` finds as ``<scene>``). Then phases 3-5's checks
    of K1-K3 at the recomposed PLY's first view. Returns the tree's root
    and the launches of both runs."""
    from PIL import Image

    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.gs import gaussians
    from multiview_inpaint_tpu_torch.pipelines import render as render_cli
    from multiview_inpaint_tpu_torch.utils import synthetic

    rec_ply = _rec_ply(s)
    work = os.path.join(s["work"], "cmp")
    shutil.rmtree(work, ignore_errors=True)
    src = os.path.join(work, "scene")
    names = synthetic.write_bench_colmap_scene(src, CMP_YAWS)
    root = os.path.join(work, "vis", "cmp", CMP_EXP)
    runs = {}
    for kind, scene, ply in (("inpainted", s["sid"], rec_ply),
                             ("src", STAGE1_SCENE, s["ply"])):
        model = os.path.join(work, "models", kind)
        dst = os.path.join(model, "point_cloud", f"iteration_{REC_ITERS}",
                           "point_cloud.ply")
        os.makedirs(os.path.dirname(dst))
        shutil.copy(ply, dst)
        _kernels.reset_launches()
        render_cli.main(["-s", src, "-m", model, "--iteration",
                         str(REC_ITERS), "--resolution", "1", "--skip_test",
                         "--device", DEVICE])
        out = os.path.join(root, kind, scene, f"ours_{REC_ITERS}")
        os.makedirs(os.path.dirname(out))
        shutil.move(os.path.join(model, "train", f"ours_{REC_ITERS}"), out)
        pngs = sorted(os.listdir(os.path.join(out, "renders")))
        shapes_ok = True
        for p in pngs:
            with Image.open(os.path.join(out, "renders", p)) as im:
                arr = np.asarray(im)
            shapes_ok &= bool(arr.shape == (synthetic.BENCH_HEIGHT,
                                            synthetic.BENCH_WIDTH, 3)
                              and arr.std() > 0)
        runs[kind] = dict(launches=dict(_kernels.LAUNCHES), pngs=len(pngs),
                          ok=shapes_ok)
    params = gaussians.load_ply(rec_ply, 0, device=DEVICE)
    checks = {}
    for kind, r in runs.items():
        checks[f"{kind}: K1 and K2 once per view ({len(names)}), K3-K5 "
               f"0"] = r["launches"] == _forward_launches(len(names))
        checks[f"{kind}: {len(names)} PNGs at the views' size, not "
               f"constant"] = (
            r["pngs"] == len(names) and r["ok"])
    print(f"[36 main cmp render] render CLI on main path 6's recomposed PLY "
          f"({params.capacity} rows) and main path 5's source PLY at "
          f"{len(names)} bench views ({synthetic.BENCH_WIDTH}x"
          f"{synthetic.BENCH_HEIGHT}) into {root} | "
          + " | ".join(f"{k}: launches {r['launches']}"
                       for k, r in runs.items())
          + f" | {json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 8 (render CLI) checks failed: {checks}")
    phase_kernels(torch, card, "cmp-rec", params,
                  synthetic.bench_camera(CMP_YAWS[0]))
    return dict(work=work, root=root,
                launches=[r["launches"] for r in runs.values()])


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.maximum(np.abs(np.asarray(b)), 1e-30)))


def phase_cmp(torch, card, s, cmp):
    """Main path 8, its scores: random full-width MUSIQ (``MUSIQConfig()``)
    and WaDIQaM-NR weights (every all-zero parameter moved) written as
    npz files in the JAX ``save_params`` layout, then the ``cmp`` CLI
    (``--n_frame 10``) on phase 36's tree, counters zeroed before: no
    kernel launches, the report's sharpness, musiq, wadiqam and
    psnr_vs_src finite for the scene and in ``mean``; on one 1080p frame
    MUSIQ and WaDIQaM on CUDA within METRIC_REL_TOL relative of the same
    weights on the CPU, and LPIPS at full VGG16 on an LPIPS_SHAPE pair
    likewise; MUSIQ's token count."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import checkpoint
    from multiview_inpaint_tpu_torch.gs import scene_io
    from multiview_inpaint_tpu_torch.metrics import lpips, musiq, wadiqam
    from multiview_inpaint_tpu_torch.pipelines import cmp as cmp_cli

    paths = dict(musiq=os.path.join(cmp["work"], "musiq.npz"),
                 wadiqam=os.path.join(cmp["work"], "wadiqam.npz"),
                 out=os.path.join(cmp["work"], "report.json"))
    torch.manual_seed(80)
    mq, wq = musiq.MUSIQ(), wadiqam.WaDIQaMNR()
    perturb_zero_params(torch, mq, 81)
    perturb_zero_params(torch, wq, 82)
    checkpoint.save_params(paths["musiq"], musiq.state_dict_to_jax(
        mq.state_dict(), mq.cfg.heads))
    checkpoint.save_params(paths["wadiqam"], checkpoint.torch_to_flax(
        wq.state_dict()))
    _kernels.reset_launches()
    cmp_cli.main(["--root", cmp["root"], "--iteration", str(REC_ITERS),
                  "--n_frame", "10", "--out", paths["out"], "--musiq_ckpt",
                  paths["musiq"], "--wadiqam_ckpt", paths["wadiqam"],
                  "--device", DEVICE])
    launches = dict(_kernels.LAUNCHES)
    with open(paths["out"]) as f:
        report = json.load(f)
    keys = {"sharpness", "musiq", "wadiqam", "psnr_vs_src"}

    frame = scene_io.load_image(os.path.join(
        cmp["root"], "inpainted", s["sid"], f"ours_{REC_ITERS}", "renders",
        "00000.png"))
    x = torch.from_numpy(frame)[None].to(DEVICE)
    scores = {}
    for name, cls in (("musiq", musiq.MUSIQScorer),
                      ("wadiqam", wadiqam.WaDIQaMScorer)):
        flat = checkpoint.load_params(paths[name])
        on = {dev: cls(flat, device=dev) for dev in ("cpu", DEVICE)}
        scores[name] = {dev: sc(frame) for dev, sc in on.items()}
        if name == "musiq":
            tokens = on[DEVICE].model.tokens(x)
    rng = np.random.default_rng(83)
    a = rng.uniform(-1, 1, LPIPS_SHAPE).astype(np.float32)
    b = np.clip(a + 0.3 * rng.normal(size=a.shape), -1, 1).astype(
        np.float32)
    lp = lpips.LPIPS()
    perturb_zero_params(torch, lp, 84)
    lp.requires_grad_(False)
    with torch.no_grad():
        d_cpu = lp(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        lp = lp.to(DEVICE)
        ta, tb = torch.from_numpy(a).to(DEVICE), torch.from_numpy(b).to(DEVICE)
        d_gpu = lp(ta, tb).cpu().numpy()
    errs = {name: _rel(v[DEVICE], v["cpu"]) for name, v in scores.items()}
    errs["lpips"] = _rel(d_gpu, d_cpu)
    checks = {
        "no kernel launches": sum(launches.values()) == 0,
        f"report: {s['sid']} and mean": set(report) == {s["sid"], "mean"},
        f"{sorted(keys)} finite per scene and in mean": all(
            set(report.get(k, {})) == keys and all(
                math.isfinite(v) for v in report[k].values())
            for k in (s["sid"], "mean")),
    }
    for name, e in errs.items():
        checks[f"{name} CUDA vs CPU within {METRIC_REL_TOL} relative"] = (
            e <= METRIC_REL_TOL)
    print(f"[37 main cmp] cmp CLI (--n_frame 10) on {cmp['root']} with "
          f"random full-width MUSIQ ({tokens} tokens per 1080p frame) and "
          f"WaDIQaM-NR npz, launches {launches} | report "
          f"{json.dumps(report)} | 1080p "
          f"frame CUDA vs CPU: MUSIQ {scores['musiq'][DEVICE]:.6g} vs "
          f"{scores['musiq']['cpu']:.6g}, WaDIQaM "
          f"{scores['wadiqam'][DEVICE]:.6g} vs "
          f"{scores['wadiqam']['cpu']:.6g}, LPIPS {d_gpu.tolist()} vs "
          f"{d_cpu.tolist()} on {list(LPIPS_SHAPE)}; relative errors "
          f"{json.dumps(errs)} | {json.dumps(checks)} | {card}",
          flush=True)
    if not all(checks.values()):
        fail(f"main path 8 (cmp CLI) checks failed: {checks}")


def phase_vae_step(torch):
    """One ``vae_finetune --tiny`` step (the generator update, then the
    discriminator's; every term on, the perceptual one through a random
    full VGG16 LPIPS) on DEVICE against the CPU from the same weights,
    batch and posterior noise (every all-zero parameter moved), f32 with
    TF32 off: every logged value
    within VAE_STEP_REL_TOL relative; the generator's gradients (Adam's
    first moment over 0.5) within GRAD_ATOL + GRAD_RTOL max|g| of their
    leaf plus 2e-7 max|g| of the network (the f32 rounding of backward
    sums whose terms run up to the network's largest gradient: the
    biases ahead of a per-channel GroupNorm and the attention's k, v and
    proj_out biases have gradients of 0 up to it); every parameter after
    the step within 2e-6 + 1e-4 max|update| of its leaf, or, where the
    CPU gradient entry is under its bar, within 2 lr (Adam's first update
    lr g / (|g| + eps) is sign-like: phase 8's sign-flip allowance)."""
    from multiview_inpaint_tpu_torch.diffusion.autoencoder_loss import (
        GANLossConfig)
    from multiview_inpaint_tpu_torch.metrics import lpips
    from multiview_inpaint_tpu_torch.pipelines import vae_finetune as vf

    lr = 2e-3
    cfg = GANLossConfig(disc_start=0, disc_weight=0.5, perceptual_weight=1.0,
                        learn_logvar=True,
                        regularization_weights=(("kl_loss", 1e-6),))
    torch.manual_seed(90)
    nets = {"cpu": [*vf.build_models(True, "cpu"), lpips.LPIPS()]}
    for i, m in enumerate(nets["cpu"]):
        perturb_zero_params(torch, m, 91 + i)
    nets[DEVICE] = [*vf.build_models(True, DEVICE), lpips.LPIPS(
        device=DEVICE)]
    for a, b in zip(nets["cpu"], nets[DEVICE]):
        b.load_state_dict(a.state_dict())
    rng = np.random.default_rng(94)
    x = np.tanh(rng.normal(size=(2, 32, 32, 3))).astype(np.float32)
    noise = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    logs, params, grads, start = {}, {}, {}, None
    for dev, (vae, disc, lp) in nets.items():
        tuner = vf.Finetuner(vae, disc, cfg, lr,
                             lpips_fn=lp.requires_grad_(False))
        if start is None:
            start = {k: p.detach().clone() for k, p in
                     tuner.gen_params.items()}
        logs[dev] = {k: float(v) for k, v in tuner.step(
            torch.from_numpy(x).to(dev), 0,
            torch.from_numpy(noise).to(dev)).items()}
        params[dev] = {k: p.detach().cpu() for k, p in
                       tuner.gen_params.items()}
        grads[dev] = {k: m.cpu() / 0.5 for k, m in
                      tuner.gen_state["mu"].items()}
    loss_err = max(abs(logs[DEVICE][k] - w) / abs(w)
                   for k, w in logs["cpu"].items() if w != 0)
    top = max(float(g.abs().max()) for g in grads["cpu"].values())
    g_worst, flips, bad = 0.0, 0, 0
    for k, w in params["cpu"].items():
        g = grads["cpu"][k]
        bar = GRAD_ATOL + 2e-7 * top + GRAD_RTOL * float(g.abs().max())
        g_worst = max(g_worst, float((grads[DEVICE][k] - g).abs().max())
                      / bar)
        upd = (w - start[k]).abs()
        err = (params[DEVICE][k] - w).abs()
        beyond = err > 2e-6 + 1e-4 * float(upd.max())
        flip = (g.abs() <= bar) & (err <= 2 * lr + 1e-6)
        flips += int(beyond.sum())
        bad += int((beyond & ~flip).sum())
    n = sum(p.numel() for p in params["cpu"].values())
    checks = {f"logs within {VAE_STEP_REL_TOL} relative":
              loss_err <= VAE_STEP_REL_TOL,
              "gradients within their bar": g_worst <= 1.0,
              "parameters within the bar or the sign-flip allowance":
              bad == 0}
    print(f"[38 vae step] one vae_finetune --tiny step (LPIPS VGG16 "
          f"perceptual term, disc_start 0) {DEVICE} vs cpu (f32, TF32 off): "
          f"loss/total {logs['cpu']['loss/total']:.6g} vs "
          f"{logs[DEVICE]['loss/total']:.6g}, worst log rel err "
          f"{loss_err:.3g} | gradients: worst err / bar {g_worst:.3g} "
          f"(network max|g| {top:.4g}) | parameters after Adam (lr {lr}): "
          f"{flips} of {n} entries beyond 2e-6 + 1e-4 max|update|, "
          f"{bad} of them outside the sign-flip allowance | "
          f"{json.dumps(checks)}", flush=True)
    if not all(checks.values()):
        fail(f"the tiny vae_finetune step on {DEVICE} disagrees with the "
             f"cpu: {checks}")


def phase_vae_finetune(torch, card, s):
    """Main path 9: the ``vae_finetune`` CLI at full width
    (``VAEConfig()``, the ndf-64 3-layer PatchDiscriminator) on main path
    5's 28 gen_seq frames (512x384, resized to VAE_RES^2), batch
    VAE_BATCH, the perceptual term through a random full VGG16 LPIPS npz
    in the ``{"params": tree}`` layout, VAE_STEPS steps with the
    adversarial terms gated on from VAE_DISC_START, counters zeroed
    before: no kernel launches; every step's log finite; ``loss/disc``
    exactly 0 at steps below VAE_DISC_START and not 0 from it on;
    ``train_log.jsonl`` at the logged steps; both npz files written and
    read back by the port equal to the trained parameters (each step's
    tuner and log captured from ``Finetuner.step``)."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.diffusion import checkpoint
    from multiview_inpaint_tpu_torch.metrics import lpips
    from multiview_inpaint_tpu_torch.pipelines import vae_finetune as vf

    work = os.path.join(s["work"], "vae_finetune")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "frames")
    os.makedirs(data)
    for mode in SEQ_MODES:
        rdir = os.path.join(s["ws"], "inpaint", "seq", s["sid"], mode,
                            "ours_1", "renders")
        for f in sorted(os.listdir(rdir)):
            shutil.copy(os.path.join(rdir, f),
                        os.path.join(data, f"{mode}_{f}"))
    n_frames = len(os.listdir(data))
    lp = lpips.LPIPS()
    perturb_zero_params(torch, lp, 95)
    lpips_npz = os.path.join(work, "lpips_vgg16.npz")
    tree = {}
    for k, v in checkpoint.torch_to_flax(lp.state_dict()).items():
        node = tree
        *body, leaf = k.split("/")
        for c in body:
            node = node.setdefault(c, {})
        node[leaf] = v
    np.savez(lpips_npz, params=tree)
    del lp
    out = os.path.join(work, "out")
    _kernels.reset_launches()
    with capture(vf.Finetuner, "step", lambda a, kw, log: (
            a[0], {k: float(v) for k, v in log.items()})) as steps:
        vf.main(["--data_dir", data, "--out_dir", out, "--resolution",
                 str(VAE_RES), "--batch_size", str(VAE_BATCH),
                 "--perceptual_weight", "1.0", "--lpips_ckpt", lpips_npz,
                 "--disc_start", str(VAE_DISC_START), "--steps",
                 str(VAE_STEPS), "--log_interval", "5", "--device", DEVICE])
    launches = dict(_kernels.LAUNCHES)
    with open(os.path.join(out, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    tuner = steps[0][0]
    saved = {name: checkpoint.load_params(os.path.join(out, name))
             for name in ("vae_params.npz", "disc_params.npz")}
    want = dict({f"params/{k}": v
                 for k, v in tuner.vae_params_jax().items()},
                logvar=tuner.logvar.detach().cpu().numpy())
    want_d = {f"params/{k}": v for k, v in tuner.disc_params_jax().items()}
    n_params = sum(p.numel() for p in tuner.gen_params.values())
    disc = [r["loss/disc"] for _, r in steps]
    checks = {
        "no kernel launches": sum(launches.values()) == 0,
        f"{VAE_STEPS} steps, every log finite": len(steps) == VAE_STEPS
        and all(math.isfinite(v) for _, r in steps for v in r.values()),
        f"loss/disc 0 at steps 0-{VAE_DISC_START - 1}, not 0 after":
        all(d == 0.0 for d in disc[:VAE_DISC_START])
        and all(d != 0.0 for d in disc[VAE_DISC_START:]),
        "train_log.jsonl every 5 steps and at the last":
        [r["step"] for r in log] == sorted({*range(0, VAE_STEPS, 5),
                                            VAE_STEPS - 1}),
        "vae_params.npz read back equal": set(saved["vae_params.npz"])
        == set(want) and all(np.array_equal(saved["vae_params.npz"][k],
                                            want[k]) for k in want),
        "disc_params.npz read back equal": set(saved["disc_params.npz"])
        == set(want_d) and all(np.array_equal(saved["disc_params.npz"][k],
                                              want_d[k]) for k in want_d),
    }
    print(f"[39 main vae_finetune] vae_finetune CLI at full width "
          f"(VAEConfig(), {n_params} generator parameters with logvar; "
          f"PatchDiscriminator(ndf=64, n_layers=3); random full VGG16 LPIPS "
          f"npz) on {n_frames} gen_seq frames at {VAE_RES}^2, batch "
          f"{VAE_BATCH}, {VAE_STEPS} steps, disc_start {VAE_DISC_START} | "
          f"launches {launches} | loss/rec "
          f"{[round(r['loss/rec'], 4) for r in log]}, loss/disc "
          f"{[round(d, 4) for d in disc]}, d_weight "
          f"{[round(r['scalars/d_weight'], 3) for r in log]} | "
          f"{json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"main path 9 (vae_finetune CLI) checks failed: {checks}")


def phase_band_frame(torch, card, params):
    """Main path 11 (a): main path 1's big2m 1080p bench frame as BANDS
    interleaved tile-row bands (``render(band_rows=, band_row0=,
    band_stride=)``) rendered one after another: stitched bit for bit
    equal to the full frame, the pairs summed equal; then the heaviest
    band's K2 call against its plain version, and its tiles bit-equal to
    the full frame's K2 call's on the same tiles. Returns the bands' K2
    launches."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        RenderCamera, api, composite, render)
    from multiview_inpaint_tpu_torch.parallel.render_parallel import (
        band_layout, stitch_bands)
    from multiview_inpaint_tpu_torch.utils import synthetic

    cam = RenderCamera.from_camera(synthetic.bench_camera(), DEVICE)
    bg = torch.zeros(3, device=DEVICE)
    tiles_x, tiles_y = -(-cam.width // TILE), -(-cam.height // TILE)
    rows, stride, row0s = band_layout(tiles_y, BANDS, True)
    # K2's calls: the full frame's, then each band's.
    with capture(api, "composite_tiles") as k2_calls, torch.no_grad():
        full = render(params, cam, bg, device=DEVICE)
        _kernels.reset_launches()
        bands = [render(params, cam, bg, device=DEVICE, band_rows=rows,
                        band_row0=r, band_stride=stride) for r in row0s]
        launches = dict(_kernels.LAUNCHES)
        equal = {f: torch.equal(stitch_bands(torch.stack(
            [getattr(b, f) for b in bands]), True, TILE, cam.height),
            getattr(full, f)) for f in ("rgb", "depth", "alpha")}
    pairs = [b.pairs for b in bands]
    del bands
    print(f"[41 band frame] big2m ({BIG_N} gaussians) 1920x1080 as "
          f"{BANDS} interleaved bands of {rows} tile rows (stride {stride}):"
          f" stitched equal to the full frame bit for bit {equal} | pairs "
          f"per band {pairs}, sum {sum(pairs)}, full frame {full.pairs} | "
          f"launches {launches} | {card}", flush=True)
    if not all(equal.values()) or sum(pairs) != full.pairs \
            or launches != _forward_launches(BANDS):
        fail("main path 11: the bands do not stitch to the full frame, "
             "their pairs do not sum to its, or the launches are off")

    d = max(range(BANDS), key=lambda i: pairs[i])
    k2_args, band, out_k = (k2_calls[1 + d].args, k2_calls[1 + d].kw,
                            k2_calls[1 + d].out)
    out_w = k2_calls[0].out
    del k2_calls
    with torch.no_grad():
        out_p = composite.composite_segments(*k2_args, **band)
        glob = torch.arange(rows, device=DEVICE) * stride + row0s[d]
        glob = glob[glob < tiles_y]
        tiles = (glob[:, None] * tiles_x
                 + torch.arange(tiles_x, device=DEVICE)).reshape(-1)
        same_tiles = torch.equal(out_k[:tiles.numel()], out_w[tiles])
    size = (tiles_x, rows, TILE, TILE, cam.width, rows * TILE)
    e_rgb, e_d, e_t, bad, within = k2_verdict(torch, out_k, out_p,
                                              k2_args[0], size)
    print(f"[41 K2 band] band {d} (heaviest: {pairs[d]} pairs in "
          f"{tiles_x * rows} tiles) vs the plain K2 with the same origin: "
          f"max abs err rgb {float(e_rgb.max()):.3g} depth "
          f"{float(e_d.max()):.3g} T {float(e_t.max()):.3g} | {bad}/"
          f"{e_d.numel()} px beyond rgb {RGB_TOL} / depth {DEPTH_TOL} | "
          f"within the stop-flip bound: {within} | tiles bit-equal to the "
          f"full frame's K2: {same_tiles} | {card}", flush=True)
    if bad > BAD_FRACTION * e_d.numel() or not within or not same_tiles:
        fail("K2 in band mode disagrees with its plain version or with "
             "the full frame")
    return launches["composite"]


def _step_cell(torch):
    """Main path 2's ball2m-train step cell: (params, camera, gt, bg)."""
    from multiview_inpaint_tpu_torch.gs import cameras
    from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera
    from multiview_inpaint_tpu_torch.utils import synthetic

    params = synthetic.make_bench_ball(STEP_N, capacity=STEP_CAPACITY,
                                       device=DEVICE)
    cam = RenderCamera.from_camera(cameras.make_camera(
        0, np.eye(3), np.array([0.0, 0.0, 3.0]), fovx=1.1, fovy=0.8,
        width=STEP_W, height=STEP_H), DEVICE)
    gt = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (STEP_H, STEP_W, 3)).astype(np.float32)).to(DEVICE)
    return params, cam, gt, torch.zeros(3, device=DEVICE)


def phase_band_step(torch, card, cell):
    """Main path 11 (b): the ball2m-train step as BANDS interleaved bands
    on one card. Each band's share of the gradients (``band_grads``: its
    render with the means2d offset, the full-frame L1+SSIM over the frame
    stitched from every band's detached rgb and its own, its backward
    through K3 in band mode) summed over the bands against
    ``train_step``'s gradients (its first Adam moments / 0.1 and its
    densification statistics) at the gradient bar, the loss equal; K3 in
    band mode against its plain version on the heaviest band. Returns the
    bands' K3 launches."""
    from multiview_inpaint_tpu_torch import kernels as _kernels
    from multiview_inpaint_tpu_torch.gs.gaussians import PARAM_FIELDS
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import render
    from multiview_inpaint_tpu_torch.parallel.gs_band_train import band_grads
    from multiview_inpaint_tpu_torch.parallel.render_parallel import (
        band_layout)

    params, cam, gt, bg = cell
    cfg = gs_trainer.OptimizationConfig()
    rows, stride, row0s = band_layout(-(-STEP_H // TILE), BANDS, True)
    state0 = gs_trainer.init_state(params)
    ref, m = gs_trainer.train_step(state0, cam, gt, bg, cfg, 1.0)
    with torch.no_grad():
        detached = torch.stack([render(
            params, cam, bg, band_rows=rows, band_row0=r, band_stride=stride,
            device=DEVICE).rgb for r in row0s])

    def gather(_):
        return detached

    _kernels.reset_launches()
    per, k3_seen = [], []
    for d in range(BANDS):
        out, _, k3_args, gid = kernel_inputs(lambda: band_grads(
            params, cam, gt, bg, cfg, BANDS, d, gather))
        per.append(out)
        k3_seen.append((k3_args, gid))
    launches = dict(_kernels.LAUNCHES)
    live = params.live
    worst, ok = {}, True
    with torch.no_grad():
        for f in PARAM_FIELDS:
            got = sum(b.grads[f] for b in per)
            rowmask = live.reshape((-1,) + (1,) * (got.dim() - 1))
            got = torch.where(rowmask & torch.isfinite(got), got, 0.0)
            want = ref.mu[f] / 0.1              # mu = 0.1 g at step 1
            if want.numel() == 0:
                continue
            bar = grad_bar(want)
            err = float((got - want).abs().max())
            worst[f] = round(err / float(bar), 4)
            ok = ok and err <= float(bar)
        g_off = sum(b.g_offset for b in per)
        acc = torch.where(ref.stats.denom > 0, torch.linalg.vector_norm(
            g_off, dim=-1), 0.0)
        e_acc = float((acc - ref.stats.grad_accum).abs().max())
        ok = ok and e_acc <= float(grad_bar(ref.stats.grad_accum))
    losses = [float(b.loss) for b in per]
    loss_equal = all(x == float(m.loss) for x in losses)
    pairs = [b.pairs for b in per]
    want_l = {"pair_expand": BANDS, "composite": BANDS,
              "composite_bwd": BANDS, "flash_attn_fwd": 0,
              "flash_attn_bwd": 0, "project": BANDS, "project_bwd": BANDS}
    print(f"[42 band step] ball2m-train ({STEP_N} gaussians in "
          f"{STEP_CAPACITY} rows, {STEP_W}x{STEP_H}) as {BANDS} interleaved "
          f"bands of {rows} tile rows: the bands' gradients summed vs "
          f"train_step's, err / bar (2e-6 + 1e-4 max|g|) per field "
          f"{json.dumps(worst)} | grad_accum err {e_acc:.3g} | loss per "
          f"band {losses} equal to train_step's {float(m.loss)}: "
          f"{loss_equal} | pairs per band {pairs}, sum {sum(pairs)}, "
          f"train_step {m.pairs} | launches {launches} | {card}",
          flush=True)
    if not (ok and loss_equal and sum(pairs) == m.pairs
            and launches == want_l):
        fail("main path 11: the band step's gradients, loss, pairs or "
             "launches disagree with train_step")
    d = max(range(BANDS), key=lambda i: pairs[i])
    check_k3(torch, card, f"42 K3 band {d}", *k3_seen[d], params.capacity)
    return launches["composite_bwd"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _step_close(torch, got, want):
    """A train step's state ``got`` against ``want`` from the same first
    step: the gradients (Adam's first moments / 0.1, the square roots of
    the second / 0.001) and grad_accum at 2e-6 + 1e-4 max|g|, denom and
    max_radii2d equal. Returns (ok, the worst err / bar)."""
    worst, ok = 0.0, True
    pairs = [(got.mu[f] / 0.1, want.mu[f] / 0.1) for f in want.mu] + [
        (torch.sqrt(got.nu[f] / 0.001), torch.sqrt(want.nu[f] / 0.001))
        for f in want.nu] + [(got.stats.grad_accum, want.stats.grad_accum)]
    for a, b in pairs:
        if b.numel():
            r = float((a - b).abs().max()) / float(grad_bar(b))
            worst, ok = max(worst, r), ok and r <= 1.0
    ok = ok and torch.equal(got.stats.denom, want.stats.denom) \
        and torch.equal(got.stats.max_radii2d, want.stats.max_radii2d)
    return ok, round(worst, 4)


def phase_distributed(torch, card, big, cell):
    """Main path 11 (c): every distributed path over NCCL at world size 1
    (``init_method`` tcp on localhost) against the single-process
    function: ``render_views_sharded`` on DIST_VIEWS orbit views of big2m
    (``render_views``) and ``render_frame_sharded`` (``render``) bit for
    bit; ``dp_train_step`` on two ball2m-train views (the same step
    without a process group), ``band_train_step`` and its ZeRO form
    (``train_step``) with the loss equal and the gradients at the
    gradient bar (``_step_close``): a train step's gradients do not repeat
    bit for bit from run to run, as the gather's backward sums each
    gaussian's pair gradients by atomic adds."""
    import torch.distributed as dist

    from multiview_inpaint_tpu_torch.gs.cameras import make_camera
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        RenderCamera, render, render_views)
    from multiview_inpaint_tpu_torch.parallel import mesh
    from multiview_inpaint_tpu_torch.parallel.gs_band_train import (
        band_train_step)
    from multiview_inpaint_tpu_torch.parallel.gs_data_parallel import (
        CameraBatch, dp_train_step, shard_for_dp)
    from multiview_inpaint_tpu_torch.parallel.render_parallel import (
        render_frame_sharded, render_views_sharded)
    from multiview_inpaint_tpu_torch.utils import synthetic

    params, cam, gt, bg = cell
    cfg = gs_trainer.OptimizationConfig()
    views = [synthetic.bench_camera(y) for y in
             np.linspace(-0.2, 0.2, DIST_VIEWS)]
    dp_cams = [make_camera(i, np.eye(3), np.array([0.1 * i, 0.0, 3.0]),
                           fovx=1.1, fovy=0.8, width=STEP_W, height=STEP_H,
                           image=np.random.default_rng(i).uniform(
                               0, 1, (STEP_H, STEP_W, 3)).astype(np.float32))
               for i in range(2)]
    zero3 = torch.zeros(3, device=DEVICE)

    def dp():
        state, batch = shard_for_dp(gs_trainer.init_state(params),
                                    CameraBatch.from_cameras(dp_cams, DEVICE))
        return dp_train_step(state, batch, bg, cfg, 1.0, cam.tan_fovx,
                             cam.tan_fovy, STEP_W, STEP_H)

    def same_render(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("rgb", "depth", "alpha", "radii")) \
            and a.pairs == b.pairs

    with torch.no_grad():
        ref_views = render_views(big, views, zero3, device=DEVICE)
        ref_frame = render(big, RenderCamera.from_camera(views[0], DEVICE),
                           zero3, device=DEVICE)
    ref_dp, ref_dp_loss = dp()
    ref_step, ref_m = gs_trainer.train_step(gs_trainer.init_state(params),
                                            cam, gt, bg, cfg, 1.0)
    mesh.init(0, 1, f"tcp://127.0.0.1:{_free_port()}", DEVICE)
    try:
        backend = dist.get_backend()
        with torch.no_grad():
            out_views = render_views_sharded(big, views, zero3, device=DEVICE)
            out_frame = render_frame_sharded(big, views[0], zero3,
                                             device=DEVICE)
        got_dp, got_dp_loss = dp()
        band, band_m = band_train_step(gs_trainer.init_state(params), cam,
                                       gt, bg, cfg, 1.0)
        zero, zero_m = band_train_step(gs_trainer.init_state(params), cam,
                                       gt, bg, cfg, 1.0, zero_sharded=True)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    closeness = {"dp_train_step": _step_close(torch, got_dp, ref_dp),
                 "band_train_step": _step_close(torch, band, ref_step),
                 "zero_sharded": _step_close(torch, zero, ref_step)}
    checks = {
        "render_views_sharded bit for bit": same_render(out_views,
                                                        ref_views),
        "render_frame_sharded bit for bit": same_render(out_frame,
                                                        ref_frame),
        "losses equal": torch.equal(got_dp_loss, ref_dp_loss)
        and torch.equal(band_m.loss, ref_m.loss)
        and torch.equal(zero_m.loss, ref_m.loss),
        "pairs equal": band_m.pairs == zero_m.pairs == ref_m.pairs,
        "steps at the gradient bar": all(ok for ok, _ in
                                         closeness.values()),
        "ZeRO rows": all(v.shape[0] == params.capacity
                         for v in zero.mu.values()),
    }
    print(f"[43 distributed] {backend} at world size 1 (tcp://127.0.0.1) "
          f"against the single-process functions: "
          f"{json.dumps(checks)} | worst err / bar of the steps' gradients "
          f"{json.dumps({k: w for k, (_, w) in closeness.items()})} | "
          f"{DIST_VIEWS} views of big2m at 1920x1080, pairs "
          f"{out_views.pairs}; the dp step on 2 views, the band and ZeRO "
          f"steps on ball2m-train, loss {float(band_m.loss):.6f} | {card}",
          flush=True)
    if backend != "nccl" or not all(checks.values()):
        fail(f"main path 11: a distributed path differs from its "
             f"single-process function at world size 1: {checks}")


def phase_host_parts(torch, card, s):
    """Main path 11 (d): ``native_io`` built from ``native/dataio.cpp``,
    decoding main path 5's gen_seq PNGs equal to PIL and through its
    ``PrefetchLoader``; then a LIVE_STEPS-step train_gs CLI run with
    ``--live_view`` on main path 2's scene: the server's page, the
    published PNG of the current render, a posted pose and the renders of
    that pose (the server asked over HTTP at each publish)."""
    import subprocess as sp

    from PIL import Image

    from multiview_inpaint_tpu_torch.data import native_io
    from multiview_inpaint_tpu_torch.pipelines import train_gs
    from multiview_inpaint_tpu_torch.utils import live_view, synthetic

    build = os.path.join(REPO, "build", "native_smoke")
    shutil.rmtree(build, ignore_errors=True)
    try:
        native_io.build(build)
        built, note = True, "built"
    except sp.CalledProcessError as e:
        if "zlib.h" not in (e.stderr or ""):
            fail(f"native_io did not build: {e.stderr}")
        built, note = False, "not built: this machine has no zlib.h"
    pngs = sorted(os.path.join(_seq_dir(s, m), "renders", n)
                  for m in SEQ_MODES
                  for n in os.listdir(os.path.join(_seq_dir(s, m),
                                                   "renders")))
    if len(pngs) != len(SEQ_MODES) * SEQ_FRAMES:
        fail(f"{len(pngs)} gen_seq PNGs, expected "
             f"{len(SEQ_MODES) * SEQ_FRAMES}")
    equal = True
    for p in pngs:
        with Image.open(p) as im:
            want = np.asarray(im.convert("RGB"))
        equal = equal and np.array_equal(native_io.decode_png(p, build), want)
    with native_io.PrefetchLoader(build_dir=build) as loader:
        jobs = [loader.submit(p) for p in pngs]
        loaded = [loader.take(j) for j in jobs]
    equal_loader = all(np.array_equal(a, native_io.decode_png(p, build))
                       for a, p in zip(loaded, pngs))
    print(f"[44 native_io] {note} from native/dataio.cpp | {len(pngs)} "
          f"gen_seq PNGs {loaded[0].shape}: decode_png equal to PIL {equal} "
          f"| PrefetchLoader (4 threads) equal {equal_loader} | the default "
          f"build/native library loads: {native_io.native_available()} | "
          f"{card}", flush=True)
    if not (equal and equal_loader) or (built and not
                                        native_io.native_available()):
        fail("native_io decodes differ from PIL, or the library did not load")

    src = os.path.join(REPO, "build", "smoke_train", "scene")
    if not os.path.isdir(src):
        synthetic.write_orbit_colmap_scene(
            src, synthetic.make_big_scene(BIG_N, device=DEVICE),
            np.linspace(-0.35, 0.35, TRAIN_VIEWS), TRAIN_W, TRAIN_H,
            TRAIN_POINTS)
    model = os.path.join(REPO, "build", "smoke_live")
    shutil.rmtree(model, ignore_errors=True)
    answers = {}

    def published(args, kw, out):
        """The frame's requested pose and rgb; at the first publish the
        page, the frame, a posted pose and the pose read back, and at each
        the frame served after it."""
        server, rgb = args
        pose = server.requested_pose()
        base = f"http://127.0.0.1:{server.port}"
        if not answers:
            answers.update(
                page=_http(base + "/"), frame=_http(base + "/frame.png"),
                post=_http(base + "/pose", json.dumps(LIVE_POSE).encode()),
                pose=_http(base + "/pose"))
        answers["last"] = _http(base + "/frame.png")
        return pose, rgb

    port = _free_port()
    with capture(live_view.LiveViewServer, "publish", published) as frames:
        train_gs.main(["-s", src, "-m", model, "--resolution", "1",
                       "--iterations", str(LIVE_STEPS), "--live_view",
                       str(port), "--live_interval", str(LIVE_INTERVAL),
                       "--test_iterations", str(LIVE_STEPS),
                       "--save_iterations", str(LIVE_STEPS),
                       "--log_interval", "10", "--device", DEVICE])

    def png(body):
        with Image.open(io.BytesIO(body)) as im:
            return np.asarray(im.convert("RGB"))

    def u8(rgb):
        return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

    first, posed = frames[0][1], frames[-1][1]
    a = answers
    checks = {
        "publishes": len(frames) == LIVE_STEPS // LIVE_INTERVAL,
        "page": a["page"][0] == 200 and b"live view" in a["page"][2],
        "first frame PNG": a["frame"][1] == "image/png"
        and np.array_equal(png(a["frame"][2]), u8(first)),
        "pose posted": a["post"][0] == 204
        and json.loads(a["pose"][2]) == LIVE_POSE,
        "later frames render the pose": all(p == LIVE_POSE
                                            for p, _ in frames[1:]),
        "last frame served": np.array_equal(png(a["last"][2]), u8(posed)),
        "posed frame differs": posed.shape == first.shape
        and not np.array_equal(u8(posed), u8(first))
        and float(posed.std()) > 0,
    }
    print(f"[44 live view] train_gs --live_view {port} --live_interval "
          f"{LIVE_INTERVAL}, {LIVE_STEPS} steps on main path 2's scene: "
          f"{len(frames)} frames {first.shape} published; "
          f"{json.dumps(checks)} | {card}", flush=True)
    if not all(checks.values()):
        fail(f"live view checks failed: {checks}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this script checks the GPU port "
             "and has no CPU fallback")
    sys.path.insert(0, REPO)
    from multiview_inpaint_tpu_torch.utils import synthetic

    t_start = time.perf_counter()
    card = phase_card(torch)
    phase_build()
    phase_kernels(torch, card, "ball100k",
                  synthetic.make_bench_ball(BALL_N, device=DEVICE))
    # big2m: the render main path's scene and shapes
    k1, k2 = phase_kernels(torch, card, "big2m",
                           synthetic.make_big_scene(BIG_N, device=DEVICE))
    k6 = phase_project(torch, card)
    k7 = phase_project_bwd(torch, card)
    phase_path(torch)
    phase_ssim(torch)
    phase_step(torch)
    launches = phase_main(torch, card)
    launches_train, k3 = phase_train(torch, card)
    phase_step_full(torch, card)
    k4 = phase_k4(torch, card, K4_SHAPES, "12", headline=True)[0]
    phase_svd_engine(torch)
    launches_svd, eng, conds = phase_svd_main(torch, card)
    phase_svd_eval(torch, card, eng, conds)
    mp12 = {"frame_sharded": phase_frame_sharded(torch, card, eng, conds)}
    del eng, conds   # main path 3's engine
    torch.cuda.empty_cache()
    mp12["cli"] = phase_shard_frames_cli(torch, card)
    torch.cuda.empty_cache()
    phase_sampling_engine(torch, card)
    mp10 = {mode: phase_svd_sampling(torch, card, mode)
            for mode in ("blended", "inversion")}
    torch.cuda.empty_cache()
    phase_k4(torch, card, K4_10_SHAPES, "15d")
    phase_divide_test(card, mp10)
    demo = phase_demo_app(torch, card)
    torch.cuda.empty_cache()
    k5 = phase_k5(torch, card)
    phase_k5_grad(torch, card)
    phase_svd_train_step(torch)
    launches_svd_train, eng = phase_svd_train(torch, card)
    mp12["ddp"] = phase_ddp_step(torch, card, eng)
    del eng     # main path 4's engine
    torch.cuda.empty_cache()
    stage1 = phase_stage1_setup(card)
    phase_gen_seq(torch, card, stage1)
    phase_mask_plain(torch, card, stage1)
    phase_stage1_clis(torch, card, stage1)
    phase_delete_gen_pc(torch, card, stage1)
    visible, fov = phase_stage2_frames(torch, card, stage1)
    phase_seg_auto(torch, card, stage1, visible, fov)
    phase_seg_ground(torch, card, stage1)
    threshold = phase_stage2_step(torch, card, stage1)
    launches_rec = phase_inpaint_rec(torch, card, stage1, threshold)
    sw = phase_slice7_setup(torch, card, stage1)
    phase_k4(torch, card, K4_2D_SHAPES, "30")
    phase_unet2d_eval(torch, card, sw)
    threshold7 = phase_sds_step(torch, card, stage1, sw)
    del sw["guidance"]
    torch.cuda.empty_cache()
    launches_sds, sds_out = phase_sds_train(torch, card, stage1, sw,
                                            threshold7)
    launches7 = [launches_sds, *phase_sds_depth(
        torch, card, stage1, sds_out).values(), *phase_ctrl_inpaint(
        torch, card, stage1, sw).values()]
    os.remove(sw["sd"])
    del sw
    torch.cuda.empty_cache()
    cmp = phase_cmp_render(torch, card, stage1)
    phase_cmp(torch, card, stage1, cmp)
    phase_vae_step(torch)
    phase_vae_finetune(torch, card, stage1)
    torch.cuda.empty_cache()
    big = synthetic.make_big_scene(BIG_N, device=DEVICE)
    band_k2 = phase_band_frame(torch, card, big)
    cell = _step_cell(torch)
    band_k3 = phase_band_step(torch, card, cell)
    phase_distributed(torch, card, big, cell)
    del big, cell
    torch.cuda.empty_cache()
    phase_host_parts(torch, card, stage1)

    def launched(name, *runs):
        """A main path's launches of one kernel over its runs."""
        return dict(launches=sum(r[name] for r in runs))

    def path12(name):
        """Main path 12's launches of one kernel: the frame-sharded clip,
        the ``--shard_frames`` CLI and the DDP steps."""
        return dict(launches={part: mp12[part][name] for part in
                              ("frame_sharded", "cli", "ddp")})

    kernels = [
        dict(name="pair_expand", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/pair_expand.cu",
             replaces="multiview_inpaint_tpu/ops/rasterizer/"
                      "pair_expand.py:92",
             launches=launches["pair_expand"], **k1,
             main_path_6=launched("pair_expand", launches_rec),
             main_path_7=launched("pair_expand", *launches7),
             main_path_8=launched("pair_expand", *cmp["launches"])),
        dict(name="composite", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/composite.cu",
             replaces="multiview_inpaint_tpu/ops/rasterizer/"
                      "pallas_composite.py:75",
             launches=launches["composite"], **k2,
             main_path_6=launched("composite", launches_rec),
             main_path_7=launched("composite", *launches7),
             main_path_8=launched("composite", *cmp["launches"]),
             band=dict(launches=band_k2)),
        # K3 at the first step of main path 2, the path that runs it.
        dict(name="composite_bwd", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/composite_bwd.cu",
             replaces="multiview_inpaint_tpu/ops/rasterizer/"
                      "pallas_backward.py:54",
             launches=launches_train["composite_bwd"], **k3,
             main_path_6=launched("composite_bwd", launches_rec),
             main_path_7=launched("composite_bwd", *launches7),
             band=dict(launches=band_k3)),
        # K6 at big2m in the bench view, SH 0 (main path 1's degree,
        # whose launches these are) with SH 3 under "sh3".
        dict(name="project", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/project.cu",
             replaces=None, launches=launches["project"], **k6),
        # K7 at big2m in the bench view, SH 3; the launches of main path
        # 2, one a step.
        dict(name="project_bwd", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/project_bwd.cu",
             replaces=None, launches=launches_train["project_bwd"], **k7),
        # K4 at the ds1 shape of main path 3, the path that runs it.
        dict(name="flash_attn_fwd", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/flash_attn_fwd.cu",
             replaces="multiview_inpaint_tpu/diffusion/"
                      "flash_attention.py:55",
             launches=launches_svd["flash_attn_fwd"], **k4,
             main_path_7=launched("flash_attn_fwd", *launches7),
             main_path_10=dict(launches=dict(
                 blended=mp10["blended"]["launches"],
                 inversion=mp10["inversion"]["launches"], demo=demo)),
             main_path_12=path12("flash_attn_fwd")),
        # K5 at the ds1 shape of main path 4, the path that runs it; one
        # launch is the dk/dv kernel and the dq kernel back to back.
        dict(name="flash_attn_bwd", route="cuda",
             source="multiview_inpaint_tpu_torch/csrc/flash_attn_bwd.cu",
             replaces="multiview_inpaint_tpu/diffusion/"
                      "flash_attention.py:117",
             launches=launches_svd_train["flash_attn_bwd"], **k5,
             main_path_12=path12("flash_attn_bwd")),
    ]
    print(f"[45 done] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
