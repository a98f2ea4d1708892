"""Driver of graphdeco-style optimisation steps through the port's
``models/gs_trainer.train_step`` at the traffic's resolution.

Set-up: the seeded scene (``inputs.scene``) at the configuration's size
and SH degree in the program's ``GaussianParams``, ``views`` seeded orbit
cameras, and their targets: the reference renderer's images of a seeded
perturbation of the scene, so that the gradients are those of a scene
near convergence. Then the first ``warm_steps`` steps (views 0, 1, 2),
which build the kernels and warm every shape; from the state they leave
the program's loss of each, its first gradient (Adam's first moment after
one step over 1 - beta1) and its change after the last are kept. The
window runs further steps on the views in turn, full L1 + SSIM loss, no
densification.

The check: the float32 reference (``reference/gs``) takes the same
first steps from the same scene, views and targets once the program is
freed. Compared: the largest relative gap of the steps' losses, and of
the norms of the first gradient and of the change, leaf by leaf, each
against the larger of the reference's norm of that leaf and of the
median leaf. A leaf whose reference gradient is under a thousandth of the
median leaf's is left out of the change's comparison.
"""

from __future__ import annotations

import sys

from port_bench.drivers import splat_common as sc
from port_bench.drivers.train_check import compare, norms
from port_bench.inputs import scene as scene_mod
from port_bench.reference.gs import model as ref_gs

FIELDS = ref_gs.FIELDS


def reference_readings(run, fields, cams, targets, opt, extent, steps,
                       lowp=False):
    torch = run.torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bg = torch.zeros(3, device=run.device)
    out = ref_gs.train_steps(fields, cams, targets, bg, opt, extent,
                             run.config["sh_degree"], steps, lowp)
    return {"losses": out["losses"], "grad_norms": norms(out["grads"]),
            "change_norms": norms({k: out["fields"][k] - fields[k]
                                   for k in FIELDS})}


def targets_of(run, fields, cams):
    torch = run.torch
    target = scene_mod.perturb(fields, run.seed_for("targets"), run.device)
    bg = torch.zeros(3, device=run.device)
    with torch.no_grad():
        return [ref_gs.render(target, cam, bg, run.config["sh_degree"])[0]
                for cam in cams]


def program_first_steps(run, fields, pcams, targets, opt, extent, params):
    """The program's first ``warm_steps`` steps from ``params``: (the
    state they leave, the readings the check compares)."""
    torch = run.torch
    from multiview_inpaint_tpu_torch.models import gs_trainer
    bg = torch.zeros(3, device=run.device)
    state = gs_trainer.init_state(params)
    prog = {"losses": []}
    for i in range(run.traffic["warm_steps"]):
        state, m = gs_trainer.train_step(state, pcams[i], targets[i], bg,
                                         opt, extent,
                                         sh_degree=run.config["sh_degree"])
        prog["losses"].append(float(m.loss))
        if i == 0:
            prog["grad_norms"] = norms({k: state.mu[k] / 0.1
                                        for k in FIELDS})
    prog["change_norms"] = norms({k: getattr(state.params, k) - fields[k]
                                  for k in FIELDS})
    return state, prog


def calibrate(run):
    """The readings the limits are set from, for one seed: the program's
    first steps, the control's (the reference with bfloat16 parameters,
    projected attributes and gradients) and the program's with half of
    its batch left out (the loss over the top half of each frame), each
    against the reference."""
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from port_bench.drivers.train_check import gaps
    fields, cams, pcams, params = sc.setup(run)
    targets = targets_of(run, fields, cams)
    opt = gs_trainer.OptimizationConfig(**run.config["optimization"])
    extent = scene_mod.camera_extent(cams)
    _, prog = program_first_steps(run, fields, pcams, targets, opt, extent,
                                  params)
    loss_terms = gs_trainer.loss_terms

    def top_half(rgb, gt, cfg, mask=None, loss_mode="full"):
        h = rgb.shape[0] // 2
        return loss_terms(rgb[:h], gt[:h], cfg, mask, loss_mode)

    gs_trainer.loss_terms = top_half
    _, half = program_first_steps(run, fields, pcams, targets, opt, extent,
                                  sc.setup(run)[3])
    gs_trainer.loss_terms = loss_terms
    run.close_program()
    steps = run.traffic["warm_steps"]
    want = reference_readings(run, fields, cams, targets, opt.__dict__,
                              extent, steps)
    control = reference_readings(run, fields, cams, targets, opt.__dict__,
                                 extent, steps, lowp=True)
    return {"program": gaps(prog, want), "control": gaps(control, want),
            "half_batch": gaps(half, want)}


def run(run):
    torch = run.torch
    from multiview_inpaint_tpu_torch.models import gs_trainer
    cfg, tr = run.config, run.traffic
    fields, cams, pcams, params = sc.setup(run)
    run.note("scene and views")
    targets = targets_of(run, fields, cams)
    run.sync()
    run.note("targets rendered by the reference")
    opt = gs_trainer.OptimizationConfig(**cfg["optimization"])
    extent = scene_mod.camera_extent(cams)
    bg = torch.zeros(3, device=run.device)
    sh = cfg["sh_degree"]
    views = len(pcams)
    if run.trace:
        sc.wrap_kernels(run, tr["captured_frames"])
        gs_trainer.render = sc.marked(run, gs_trainer.render, "render",
                                      None, "render")
        gs_trainer.apply_adam = sc.marked(run, gs_trainer.apply_adam,
                                          "adam", "adam_in", "adam_out")
    state, prog = program_first_steps(run, fields, pcams, targets, opt,
                                      extent, params)
    run.note("first steps")

    def step(i):
        nonlocal state
        v = (tr["warm_steps"] + i) % views
        start = run.spans.event() if run.trace else None
        with run.spans.label("step"):
            state, _ = gs_trainer.train_step(state, pcams[v], targets[v],
                                             bg, opt, extent, sh_degree=sh)
        if run.trace:
            marks = run.readings.captures["marks"]
            run.spans.add("render", start, marks["render"])
            run.spans.add("backward", marks["render"], marks["adam_in"])
            run.spans.add("adam", marks["adam_in"], marks["adam_out"])

    units, window_s = run.window(step, traced=tr["traced_steps"])
    print(f"window: {units} steps in {window_s!r} s", file=sys.stderr)
    run.readings.captures["pixels"] = tr["width"] * tr["height"]
    run.readings.captures["splats"] = cfg["num_gaussians"]
    del state, params
    run.close_program()
    want = reference_readings(run, fields, cams, targets, opt.__dict__,
                              extent, tr["warm_steps"])
    run.note("reference steps")
    ok = compare(run, prog, want)
    return {"correct": ok, "attempted": units, "failed": 0 if ok else 1,
            "end_to_end": {"gs_step_ms": window_s * 1e3 / units,
                           "setup_s": run.setup_s}}
