"""Driver of 1080p frames through the port's ``ops/rasterizer/api.render``.

Set-up: the seeded scene (``inputs.scene``) at the configuration's size
and SH degree in the program's ``GaussianParams`` and ``views`` seeded
orbit cameras, then one frame of each view, which builds the kernels and
warms every shape. The window renders the views in turn without
gradients, as ``render``, ``gen_seq``, ``cmp`` and the live view do;
rgb and depth stay on the card.

The check: ``checked_frames`` frames, drawn from the seed among the
window's first ``checked_among``, are kept; once the program is freed the
float32 reference (``reference/gs``) renders the same views, and the rms
gaps of rgb and of depth are held to the traffic's limits.
"""

from __future__ import annotations

import sys

from port_bench.drivers import splat_common as sc
from port_bench.reference.gs import model as ref_gs


def checked(run, frames: int, among: int) -> list:
    torch = run.torch
    g = torch.Generator().manual_seed(run.seed_for("check"))
    return sorted(torch.randperm(among, generator=g)[:frames].tolist())


def gaps(run, kept, cams, fields, lowp=False) -> dict:
    """The largest rms gaps of rgb and depth between the kept frames and
    the reference's (the control's with ``lowp``) renders of their
    views."""
    torch = run.torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bg = torch.zeros(3, device=run.device)
    out = {"rgb_rms": 0.0, "depth_rms": 0.0}
    with torch.no_grad():
        for v, (rgb, depth) in kept:
            want_rgb, want_depth = ref_gs.render(
                fields, cams[v], bg, run.config["sh_degree"], lowp)
            out["rgb_rms"] = max(out["rgb_rms"], sc.rms(rgb, want_rgb))
            out["depth_rms"] = max(out["depth_rms"],
                                   sc.rms(depth, want_depth))
    return out


def compare(run, kept, cams, fields) -> bool:
    limits = run.traffic["limits"]
    return all([run.compare(k, v, limits[k])
                for k, v in gaps(run, kept, cams, fields).items()])


def calibrate(run):
    """The readings the limits are set from, for one seed: the program's
    first ``checked_frames`` views and the control's (the reference with
    bfloat16 projected attributes), each against the reference."""
    torch = run.torch
    from multiview_inpaint_tpu_torch.ops.rasterizer import api
    fields, cams, pcams, params = sc.setup(run)
    bg = torch.zeros(3, device=run.device)
    kept = []
    with torch.no_grad():
        for v in range(run.traffic["checked_frames"]):
            out = api.render(params, pcams[v], bg,
                             sh_degree=run.config["sh_degree"],
                             device=run.device)
            kept.append((v, (out.rgb, out.depth)))
    del params
    run.close_program()
    return {"program": gaps(run, kept, cams, fields),
            "control": gaps(run, kept, cams, fields, lowp=True)}


def run(run):
    torch = run.torch
    from multiview_inpaint_tpu_torch.ops.rasterizer import api
    cfg, tr = run.config, run.traffic
    fields, cams, pcams, params = sc.setup(run)
    run.note("scene and views")
    bg = torch.zeros(3, device=run.device)
    sh = cfg["sh_degree"]
    views = len(pcams)
    if run.trace:
        sc.wrap_kernels(run, tr["captured_frames"])
        api.project = sc.marked(run, api.project, "project", "project_in",
                                "project_out")
    want = set(checked(run, tr["checked_frames"], tr["checked_among"]))
    kept = []

    def frame(i):
        with run.spans.label("frame"):
            out = api.render(params, pcams[i % views], bg, sh_degree=sh,
                             device=run.device)
        if run.trace:
            marks = run.readings.captures["marks"]
            run.spans.add("projection", marks["project_in"],
                          marks["project_out"])
        if i in want:
            kept.append((i % views, (out.rgb, out.depth)))

    with torch.no_grad():
        run.spans.enabled = False
        for v in range(views):
            api.render(params, pcams[v], bg, sh_degree=sh,
                       device=run.device)
        run.sync()
        run.note("one frame of each view")
        run.spans.enabled = run.trace
        units, window_s = run.window(frame, traced=tr["traced_frames"])
    print(f"window: {units} frames in {window_s!r} s", file=sys.stderr)
    run.readings.captures["pixels"] = tr["width"] * tr["height"]
    run.readings.captures["splats"] = cfg["num_gaussians"]
    del params
    run.close_program()
    if len(kept) < tr["checked_frames"]:
        raise RuntimeError(f"{len(kept)} of the frames to check were "
                           f"rendered")
    ok = compare(run, kept, cams, fields)
    run.note("reference frames")
    return {"correct": ok, "attempted": units, "failed": 0 if ok else 1,
            "end_to_end": {"frame_ms": window_s * 1e3 / units,
                           "setup_s": run.setup_s}}
