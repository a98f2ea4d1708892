"""What the splat drivers share: the scene, views and program objects
of a run, and the wrappers that time the program's layers and keep the
traced frames' pair lists for the rooflines."""

from __future__ import annotations

from port_bench.inputs import scene as scene_mod


def setup(run):
    """(scene fields, benchmark cameras, program cameras, program params)
    of the run."""
    torch = run.torch
    from multiview_inpaint_tpu_torch.gs.gaussians import GaussianParams
    from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera
    run.note("the program's modules imported")
    cfg, tr = run.config, run.traffic
    fields = scene_mod.make_scene(cfg["num_gaussians"], cfg["sh_degree"],
                                  cfg["layout_seed"], run.seed_for("scene"),
                                  run.device)
    cams = scene_mod.orbit_cameras(
        tr["views"], tr["yaw_span"], tr["distance"], tr["width"],
        tr["height"], tr["fovx"], tr["fovy"], run.seed_for("views"),
        run.device)
    pcams = [RenderCamera(world_view=c.world_view, full_proj=c.full_proj,
                          campos=c.campos, tan_fovx=c.tan_fovx,
                          tan_fovy=c.tan_fovy, width=c.width,
                          height=c.height) for c in cams]
    n = cfg["num_gaussians"]
    params = GaussianParams(
        live=torch.ones(n, dtype=torch.bool, device=run.device),
        **{f: v.clone() for f, v in fields.items()})
    return fields, cams, pcams, params


def wrap_kernels(run, keep_frames: int):
    """While the profiler is on: keep K1's (total pairs, active splats)
    of every frame and K2's inputs of the first ``keep_frames`` frames."""
    from multiview_inpaint_tpu_torch.ops.rasterizer import api, binning
    caps = run.readings.captures
    k1, k2 = caps.setdefault("k1", []), caps.setdefault("k2", [])
    expand_keys, composite_tiles = binning.expand_keys, api.composite_tiles

    def keys(starts, x0, y0, w, count, n_active, total, tiles_x):
        if run.tracing:
            k1.append((int(total), int(n_active)))
        return expand_keys(starts, x0, y0, w, count, n_active, total,
                           tiles_x)

    def composite(attrs, seg_start, counts, tiles_x, tiles_y, tile_h,
                  tile_w, **kw):
        if run.tracing and len(k2) < keep_frames:
            k2.append((attrs.detach(), seg_start, counts,
                       (tiles_x, tiles_y, tile_h, tile_w)))
        return composite_tiles(attrs, seg_start, counts, tiles_x, tiles_y,
                               tile_h, tile_w, **kw)

    binning.expand_keys, api.composite_tiles = keys, composite


def marked(run, fn, name, before, after):
    """``fn`` labelled ``name`` in the trace, with a device event recorded
    before it (if ``before``) and after it into ``marks``."""
    marks = run.readings.captures.setdefault("marks", {})

    def call(*a, **kw):
        if before:
            marks[before] = run.spans.event()
        with run.spans.label(name):
            out = fn(*a, **kw)
        marks[after] = run.spans.event()
        return out
    return call


def rms(a, b) -> float:
    return float((a.float() - b.float()).pow(2).mean().sqrt())
