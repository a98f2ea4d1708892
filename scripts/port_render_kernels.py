"""Time the render forward's kernels, K1 (pair keys) and K2 (composite),
on one NVIDIA GPU at the render cells of ``chip_smoke.py``.

    python3 scripts/port_render_kernels.py [--root DIR] [--k2 CONFIGS]
                                           [--cells CELLS] [--stats]

Builds the kernels of the checkout at ``--root`` (default: this one) and
imports the port and ``chip_smoke.py`` from there, so that two checkouts
can be timed on one card, one process each; every checkout is timed by
this checkout's ``chip_smoke.cuda_ms`` (CUDA events over back-to-back
launches queued behind a device sleep). For each cell (the 1080p bench
frame of the 100k bench ball and of the 2M-gaussian scene, and the first
view of main path 2's orbit scene at 960x540 from 200,000 of its points,
as its first train step renders it) it makes K1's and K2's inputs,
checks K1's keys bit for bit against the plain version and times K1
(50 launches). With ``--stats`` it counts K2's warp-splat steps
(``warp_steps``). Then, for each K2 configuration of ``--k2``
(``default``: the wrapper as it stands; ``by_depth`` / ``tile_order``:
the launch order forced, the sort included), it counts the pixels beyond
rgb 3e-5 / depth 3e-4 against the plain K2 and times K2 (10 launches),
with and without the per-item state. Prints one line per cell and
configuration with the card's name and power limit, then one JSON line
of every result. Imports the port only (no JAX).
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("ball100k", "big2m", "orbit-train")


def cell_inputs(torch, cs, cell):
    """(K1's arguments, K2's arguments) of one cell, made on the card."""
    from multiview_inpaint_tpu_torch.gs.scene import Scene
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        RenderCamera, api, binning, composite_cuda, pair_expand)
    from multiview_inpaint_tpu_torch.utils import synthetic

    dev = cs.DEVICE
    if cell == "orbit-train":
        work = os.path.join(cs.REPO, "build", "render_kernels_orbit")
        shutil.rmtree(work, ignore_errors=True)
        src = os.path.join(work, "scene")
        # The first of main path 2's views (yaw -0.35) and its init points.
        synthetic.write_orbit_colmap_scene(
            src, synthetic.make_big_scene(cs.BIG_N, device=dev),
            np.linspace(-0.35, 0.35, cs.TRAIN_VIEWS)[:1], cs.TRAIN_W,
            cs.TRAIN_H, cs.TRAIN_POINTS)
        scene = Scene(src, os.path.join(work, "model"), resolution=1,
                      device=dev)
        params = scene.gaussians
        cam = RenderCamera.from_camera(scene.train_cameras()[0], dev)
    else:
        params = (synthetic.make_bench_ball(cs.BALL_N, device=dev)
                  if cell == "ball100k"
                  else synthetic.make_big_scene(cs.BIG_N, device=dev))
        cam = RenderCamera.from_camera(synthetic.bench_camera(), dev)
    tile = cs.TILE
    tiles_x, tiles_y = -(-cam.width // tile), -(-cam.height // tile)
    with torch.no_grad():
        proj = api.project(params, cam, 0)
    r = binning.compact_rects(proj.means2d, proj.radius, proj.depth,
                              tiles_x, tiles_y, tile, tile, proj.extent)
    k1_args = (r.starts, r.x0, r.y0, r.w, r.count, r.n_active, r.total,
               tiles_x)
    keys = torch.sort(pair_expand.expand_keys_ref(*k1_args)).values
    counts, seg_start = binning.segments_from_keys(keys, tiles_x * tiles_y)
    gid = r.order[keys & 0xFFFFFFFF]
    attrs = composite_cuda.pack_attrs(
        proj.means2d, proj.conic, proj.opacity, proj.color,
        proj.depth)[gid].contiguous()
    return k1_args, (attrs, seg_start, counts, tiles_x, tiles_y, tile, tile)


def beyond(torch, cs, got, want):
    """Pixels whose rgb (3e-5) or depth (3e-4, the sentinel through the
    final T) differ beyond K2's bars, and the largest difference."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite
    e_rgb = (got[:, 0:3] - want[:, 0:3]).abs().amax(1)
    depth = lambda t: t[:, 3] + t[:, 4] * composite.DEPTH_EMPTY  # noqa
    e_d = (depth(got) - depth(want)).abs()
    e_t = (got[:, 4] - want[:, 4]).abs()
    bad = int(((e_rgb > cs.RGB_TOL) | (e_d > cs.DEPTH_TOL)
               | (e_t > cs.RGB_TOL)).sum())
    return bad, float(max(e_rgb.max(), e_d.max(), e_t.max()))


def warp_steps(torch, attrs, seg_start, counts, tiles_x, tiles_y, th, tw):
    """Warp-splat steps of K2's walk on these inputs, from the plain
    version's recomputation of each chunk (``composite._chunk``), with
    the warps of ``composite.warp_pixels``: steps where some lane of the
    warp still walks (``walk``: the warp runs the splat's power), where
    some walking lane reaches the early reject's power (``gate``: it runs
    the expf), keeps it (``kept``: log1p and the stop test) or is
    weighted by it (``contrib``); the walking steps whose gate box meets
    the warp's rectangle (``box``) and all steps whose box meets it,
    walking or not (``box_all``); and the sum over warps and chunks of
    the most splats any one lane keeps (``lane_kept``), and over warps
    and 32-splat groups of the most candidates (power >= -4.6) any one
    walking lane has (``lane_group``)."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import composite as c
    dev = attrs.device
    pix = th * tw
    coords = c.tile_pixel_coords(tiles_x, tiles_y, tw, th, dev)
    perm = c.warp_pixels(th, tw).to(dev)
    box = c.gate_box(attrs)
    t_carry = torch.ones((tiles_x * tiles_y, pix), device=dev)
    lane = torch.arange(c.CHUNK, device=dev)
    zero = torch.zeros((), device=dev)
    names = ("walk", "gate", "kept", "contrib", "box", "box_all",
             "lane_kept", "lane_group")
    n = torch.zeros(len(names), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for c0, tl in c._chunks(counts, pix, c.CHUNK):
            s = c._chunk(attrs, seg_start, counts, coords, t_carry, tl, c0,
                         lane, zero)
            a = s.a[:, None]
            power = (-0.5 * (a[..., 2] * s.dx * s.dx + a[..., 4] * s.dy
                             * s.dy) - a[..., 3] * s.dx * s.dy)
            walked = s.ok[:, None, :] & (s.t_in >= c.T_STOP)
            per_warp = lambda m: m[:, perm].reshape(  # noqa: E731
                m.shape[0], pix // 32, 32, -1)
            kept = walked & s.keep
            steps = [per_warp(walked), per_warp(walked & (power >= -4.6)),
                     per_warp(kept), per_warp(kept & s.contrib)]
            walk = steps[0].any(2)                          # [L, W, C]
            xy = per_warp(coords[tl])                        # [L, W, 32, 2]
            lo, hi = xy.amin(2), xy.amax(2)                  # [L, W, 2]
            b = box[s.idx][:, None]                          # [L, 1, C, 4]
            meets = ((b[..., 0] <= hi[..., 0:1]) & (b[..., 1] >= lo[..., 0:1])
                     & (b[..., 2] <= hi[..., 1:2])
                     & (b[..., 3] >= lo[..., 1:2]))
            meets = meets & s.ok[:, None, :]
            cand = torch.nn.functional.pad(steps[1], (0, -s.ok.shape[1] % 32))
            n += torch.stack([m.any(2).sum() for m in steps]
                             + [(walk & meets).sum(), meets.sum(),
                                per_warp(kept).sum(3).amax(2).sum(),
                                cand.reshape(*cand.shape[:3], -1, 32).sum(4)
                                .amax(2).sum()])
            t_carry[tl] = t_carry[tl] * torch.exp(torch.sum(
                torch.where(s.contrib, s.logs, zero), dim=-1))
    return dict(zip(names, n.tolist()))


def k2_configs(composite_cuda, names):
    """(name, keyword arguments of ``_launch``) of each configuration the
    checkout's wrapper takes: ``default`` as the wrapper stands,
    ``by_depth`` and ``tile_order`` with the launch order forced."""
    takes = inspect.signature(composite_cuda._launch).parameters
    out = []
    for name in names:
        if name not in ("default", "by_depth", "tile_order"):
            raise SystemExit(f"unknown K2 configuration {name!r}")
        if name == "default":
            out.append((name, {}))
        elif "by_depth" in takes:
            out.append((name, {"by_depth": name == "by_depth"}))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--k2", default="default,by_depth,tile_order")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--label", default="")
    ap.add_argument("--stats", action="store_true",
                    help="also count K2's warp-splat steps (warp_steps)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_render_kernels: torch sees no CUDA device")
    import chip_smoke as cs
    from multiview_inpaint_tpu_torch.ops.rasterizer import (
        composite, composite_cuda, pair_expand)

    # Every checkout is timed by this one's cuda_ms.
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(REPO, "chip_smoke.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)

    label = args.label or os.path.relpath(root, REPO) or "."
    card = cs.phase_card(torch)
    cs.phase_build()
    results = []
    for cell in args.cells.split(","):
        k1_args, k2_args = cell_inputs(torch, cs, cell)
        same = torch.equal(pair_expand.expand_keys(*k1_args),
                           pair_expand.expand_keys_ref(*k1_args))
        k1_ms = timing.cuda_ms(
            torch, lambda: pair_expand.expand_keys(*k1_args), 50)
        print(f"[{label} {cell} K1] pairs {k1_args[6]} actives "
              f"{k1_args[5]}: keys equal {same} | {k1_ms:.4f} ms | {card}",
              flush=True)
        if not same:
            raise SystemExit(f"K1 keys differ from the plain version at "
                             f"{cell}")
        results.append(dict(cell=cell, kernel="K1", ms=k1_ms))
        if args.stats:
            steps = warp_steps(torch, *k2_args)
            print(f"[{label} {cell} K2 steps] {json.dumps(steps)}",
                  flush=True)
            results.append(dict(cell=cell, kernel="K2", steps=steps))
        with torch.no_grad():
            want = composite.composite_segments(*k2_args)
        n_pix = want.shape[0] * want.shape[2]
        for name, kw in k2_configs(composite_cuda, args.k2.split(",")):
            def run(with_state=False, kw=kw):
                return composite_cuda._launch(*k2_args, with_state, **kw)
            with torch.no_grad():
                bad, err = beyond(torch, cs, run(), want)
                ms = timing.cuda_ms(torch, run, 10)
                ms_st = timing.cuda_ms(torch, lambda: run(True), 10)
            print(f"[{label} {cell} K2 {name}] {bad}/{n_pix} px beyond rgb "
                  f"{cs.RGB_TOL} / depth {cs.DEPTH_TOL}, max err {err:.3g} "
                  f"| {ms:.4f} ms, with the per-item state {ms_st:.4f} ms "
                  f"| {card}", flush=True)
            results.append(dict(cell=cell, kernel="K2", config=name, ms=ms,
                                ms_state=ms_st, bad_px=bad, max_err=err))
        del k1_args, k2_args, want
        torch.cuda.empty_cache()
    print(json.dumps({"label": label, "card": card, "results": results}),
          flush=True)


if __name__ == "__main__":
    main()
