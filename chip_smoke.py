#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Drives ``multiview_inpaint_tpu_torch`` only (never JAX, never the JAX
package), phase by phase, one line each; any failure raises and exits
non-zero:

1. the card (``nvidia-smi`` name and power limit), torch, TF32 settings
   (both TF32 switches are set off, so the plain versions run in fp32);
2. build the CUDA kernels from ``multiview_inpaint_tpu_torch/csrc``;
3. K1 (pair keys) against its plain version, bit for bit, on the 1080p
   bench frames of the 100k bench ball and the 2M-gaussian scene;
4. K2 (composite) against its plain version on the same frames: max
   errors, pixels beyond rgb 3e-5 / depth 3e-4 (at most 0.01%), every
   pixel within the stop-flip bound;
5. the port's whole render path on CUDA against its CPU path on a small
   scene (rgb 3e-5, depth 3e-4), 16x16 and 8x16 tiles;
6. the main path: the ``render`` CLI on a 1920x1080 COLMAP scene (the
   bench camera and three yaw offsets) holding a 2M-gaussian PLY, with
   the kernel launch counters zeroed before and read after; then, for
   that scene and the 100k bench ball, the median ms/frame over those
   views (CUDA events, after one warm-up view) and a per-stage split of
   the bench view;
7. the ``kernels`` JSON line; the last line is the ``ok`` JSON object.

Build outputs and the scene go under ``build/`` in the checkout.
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
# K2 work per pair-pixel: the gate path every pair-pixel runs (2 subs,
# 9 ops of the quadratic form, the opacity product and clamp, 2 gate
# compares) and 2 special-function ops (the alpha exp and one of the
# transmittance path).
K2_FLOP_PER_PAIR_PIXEL = 15
K2_SFU_PER_PAIR_PIXEL = 2
RGB_TOL, DEPTH_TOL, BAD_FRACTION = 3e-5, 3e-4, 1e-4
TILE = 16


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
    """Phases 3-4 on one 1080p bench frame; returns the K1 and K2
    records of the kernels line (launches filled in later)."""
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
                          lambda: pair_expand.expand_keys_ref(*k1_args), 10)
    k1_bytes = r.total * 8 + r.n_active * (8 + 4 + 4 + 4 + 8)
    k1 = dict(max_abs_err=0.0, ms=k1_ms, plain_ms=k1_plain_ms,
              bound_ms=k1_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
              library_ms=None)
    print(f"[3 K1 {name}] n={params.capacity} actives={r.n_active} "
          f"pairs={r.total}: keys, sorted keys, seg_start, counts equal | "
          f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, bound "
          f"{k1['bound_ms']:.4f} ms (bytes) | {card}", flush=True)

    counts, seg_start = seg_k
    attrs = composite_cuda.pack_attrs(
        proj.means2d, proj.conic, proj.opacity, proj.color,
        proj.depth)[r.order[sorted_k & 0xFFFFFFFF]].contiguous()
    k2_args = (attrs, seg_start, counts, tiles_x, tiles_y, TILE, TILE)
    with torch.no_grad():
        out_k = composite_cuda.composite(*k2_args)
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
    k2_ms = cuda_ms(torch, lambda: composite_cuda.composite(*k2_args), 20)
    with torch.no_grad():
        k2_plain_ms = cuda_ms(
            torch, lambda: composite.composite_segments(*k2_args), 2)
    pair_pixels = r.total * pix
    t_bytes = (r.total * 64 + n_tiles * 16
               + n_tiles * 8 * pix * 4) / HBM_BYTES_PER_S
    t_ops = max(pair_pixels * K2_FLOP_PER_PAIR_PIXEL / FP32_FLOP_PER_S,
                pair_pixels * K2_SFU_PER_PAIR_PIXEL / SFU_OP_PER_S)
    k2 = dict(max_abs_err=float(max(e_rgb.max(), e_d.max(), e_t.max())),
              ms=k2_ms, plain_ms=k2_plain_ms,
              bound_ms=max(t_bytes, t_ops) * 1e3,
              bound_by="bytes" if t_bytes >= t_ops else "operations",
              library_ms=None)
    print(f"[4 K2 {name}] max abs err rgb {float(e_rgb.max()):.3g} depth "
          f"{float(e_d.max()):.3g} T {float(e_t.max()):.3g} | {bad}/{n_pix} "
          f"px beyond rgb {RGB_TOL} / depth {DEPTH_TOL} | all px within "
          f"stop-flip bound: {within} | kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain_ms:.2f} ms, bound {k2['bound_ms']:.4f} ms "
          f"({k2['bound_by']}) | {card}", flush=True)
    if bad > BAD_FRACTION * n_pix or not within:
        fail(f"K2 disagrees with its plain version on {name}")
    return k1, k2


def phase_path(torch):
    """The whole render path on DEVICE against the CPU path."""
    from multiview_inpaint_tpu_torch.gs import cameras
    from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera,
                                                            render)
    from multiview_inpaint_tpu_torch.utils import synthetic

    small = synthetic.make_gt_gaussians(300, seed=3, spread=1.0,
                                        device="cpu")
    cam = cameras.make_camera(0, np.eye(3), np.array([0.0, 0.0, 3.0]),
                              fovx=0.9, fovy=0.7, width=96, height=64)
    bg = [0.1, 0.2, 0.3]
    for tile in ((16, 16), (8, 16)):
        with torch.no_grad():
            a = render(small, RenderCamera.from_camera(cam, "cpu"), bg,
                       tile=tile, device="cpu")
            b = render(small, RenderCamera.from_camera(cam, DEVICE), bg,
                       tile=tile, device=DEVICE)
        e_rgb = float((a.rgb - b.rgb.cpu()).abs().max())
        e_d = float((a.depth - b.depth.cpu()).abs().max())
        print(f"[5 path {tile[0]}x{tile[1]}] {DEVICE} vs cpu render, pairs "
              f"{b.pairs}: max abs err rgb {e_rgb:.3g} depth {e_d:.3g}",
              flush=True)
        if not (a.pairs == b.pairs and e_rgb <= RGB_TOL
                and e_d <= DEPTH_TOL):
            fail(f"{DEVICE} render path disagrees with the cpu path")


def phase_main(torch, card):
    """The render CLI on the 2M-gaussian 1080p scene; returns the launch
    counts of that run."""
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
                     "--skip_test"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    n_views = len(names)
    if launches != {"pair_expand": n_views, "composite": n_views}:
        fail(f"main path launches {launches}, expected {n_views} each")
    out_dir = os.path.join(model, "train", "ours_1", "renders")
    pngs = sorted(os.listdir(out_dir))
    if len(pngs) != n_views:
        fail(f"{len(pngs)} PNGs written, expected {n_views}")
    for p in pngs:
        with Image.open(os.path.join(out_dir, p)) as im:
            arr = np.asarray(im)
        if arr.shape != (1080, 1920, 3) or arr.std() == 0:
            fail(f"{p}: shape {arr.shape}, constant={arr.std() == 0}")

    print(f"[6 main] render CLI, {BIG_N} gaussians, {n_views} views at "
          f"1920x1080 in {cli_s:.1f} s (PNGs written) | "
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
    print(f"[6 frame {name}] median {statistics.median(times):.3f} "
          f"ms/frame over {len(times)} views at 1920x1080 (CUDA events, "
          f"after one warm-up view; all {[round(t, 3) for t in times]}; "
          f"pairs {pairs}) | {card}", flush=True)
    split = stage_split(torch, params, cams[0])
    print(f"[6 stages {name}] ms per stage of the bench view: "
          f"{json.dumps({k: round(v, 4) for k, v in split.items()})} | "
          f"{card}", flush=True)


def stage_split(torch, params, cam):
    """Device ms of each step of ``api.render`` for one frame, timed with
    CUDA events (mean of 5 frames after a warm-up frame)."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        api, binning, composite_cuda, pair_expand)
    tiles_x, tiles_y = -(-cam.width // TILE), -(-cam.height // TILE)
    names = ("project", "rects_compact", "K1_pair_keys", "sort",
             "segments", "gather_attrs", "K2_composite", "assemble")
    totals = dict.fromkeys(names, 0.0)
    for it in range(6):
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
                totals[n] += ev[i].elapsed_time(ev[i + 1]) / 5
    return totals


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this script measures the GPU port "
             "and has no CPU fallback")
    sys.path.insert(0, REPO)
    from multiview_inpaint_tpu_torch.utils import synthetic

    card = phase_card(torch)
    phase_build()
    frames = {}
    for name, make in (("ball100k", synthetic.make_bench_ball),
                       ("big2m", synthetic.make_big_scene)):
        n = BALL_N if name == "ball100k" else BIG_N
        frames[name] = phase_kernels(torch, card, name,
                                     make(n, device=DEVICE))
    phase_path(torch)
    launches = phase_main(torch, card)

    k1, k2 = frames["big2m"]   # the main path's scene and shapes
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
