"""Driver of the score-distillation step through the port's
``models/sds_trainer.sds_train_step``, the function ``sds_train`` calls
each iteration, with the SD-2-inpainting prior at published width.

Set-up: the insertion scene (``inputs.insertion``: the splat layout at
the configuration's size and SH degree, the box's rows deleted and
``n_samples`` new ones added in it), ``views`` seeded orbit cameras, each
view's box mask (against the depth of the reference's render of the
background) and target (the reference's render of the background seeded
slightly off), text embeddings [2, L, D] drawn
from the seed, and the prior as the CLI holds it: ``UNet2D`` and
``AutoencoderKL`` (no video decoder) in float32 on the card with the
benchmark's seeded weights read through ``checkpoint.import_state_dict``
(as ``build_guidance`` reads a checkpoint), frozen, in the
``SDSGuidance`` of ``pipelines/sds_train.make_guidance``. The precision
is the CLI's, PyTorch's defaults, set from the configuration's
``compute`` before the program runs: cuDNN convolutions in TF32, matrix
products in float32, K4 on bfloat16-rounded operands. Then the first
``warm_steps`` steps (views 0, 1, 2) with ``t`` and the noise drawn from
the seed and passed in; from them the program's SDS and total losses,
the first gradient of the box's rows (Adam's first moment after one step
over 1 - beta1), the change of every row after the last (each field as
two leaves, the scene's rows and the box's), and the SDS
gradient with respect to the first step's 512^2 image are kept. The
window runs further steps on the views in turn with ``INPAINT_OPT``,
``sds_weight``, ``sds_size`` and the guidance scale of the
configuration, the draws from a generator as the CLI draws them; no
densification.

With ``--trace 1`` the program's spans (``telemetry``) are on, with
device events, over the window's steps and off before the profiled ones
(their ``record_function`` ranges would count as device work there); the
window's ``snapshot()`` is kept in ``captures["telemetry"]``. K4's calls
and K1's and K2's inputs are kept over the profiled steps.

The check: the float32 reference (``reference/sd2``, TF32 off) takes the
same first steps from the same scene, views, draws and weights once the
program is freed, and takes the SDS gradient of the program's first
image. Compared: ``sds_grad_rms``, the relative rms of the two SDS
gradients; ``loss_gap``, the largest relative gap of the steps' SDS and
total losses; ``box_grad_gap`` and ``change_gap`` as a training cell's
check (``train_check``) computes them, the first over the box's rows.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import NamedTuple

from port_bench.drivers import splat_common as sc
from port_bench.drivers.svd_clip import rel_rms, wrap_attention
from port_bench.drivers.train_check import leaf_gap, norms
from port_bench.inputs import insertion
from port_bench.inputs import scene as scene_mod
from port_bench.inputs.weights import seeded
from port_bench.reference.gs import model as ref_gs
from port_bench.reference.sd2 import prior as ref_prior
from port_bench.reference.sd2 import step as ref_step
from port_bench.reference.svd.model import _tuples

FIELDS = ref_gs.FIELDS
# The reference's precision: float32 products and convolutions.
REFERENCE_COMPUTE = {"cudnn_allow_tf32": False, "matmul_allow_tf32": False}


def configs(cfg: dict):
    """The reference's (UNetConfig, VAEConfig) of ``cfg``."""
    from port_bench.reference.sd2.unet import UNetConfig
    from port_bench.reference.svd.vae import VAEConfig
    return UNetConfig(**_tuples(cfg["unet"])), VAEConfig(**_tuples(cfg["vae"]))


def weight_list(cfg: dict) -> list:
    """The prior's (key, shape) list in the checkpoint's key space, worked
    out on the meta device once per checkout (``harness.cache``)."""
    from port_bench.harness import cache
    key = [cfg["unet"], cfg["vae"], cache.sources_key(
        os.path.dirname(os.path.dirname(ref_prior.__file__)))]
    spec = cache.memo("sd2-weights", key, lambda: [
        [k, list(s)] for k, s in ref_prior.weight_spec(*configs(cfg))])
    return [(k, tuple(shape)) for k, shape in spec]


def seeded_weights(run, spec) -> dict:
    return seeded(spec, run.seed_for("weights"), run.device,
                  lambda key: run.torch.float32)


def set_compute(torch, compute: dict) -> None:
    """The configuration's precision: PyTorch's defaults."""
    torch.backends.cudnn.allow_tf32 = compute["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = compute["matmul_allow_tf32"]


class Inputs(NamedTuple):
    scene: dict          # fields, the box's new rows last
    new_rows: int
    cams: list           # benchmark cameras
    pcams: list          # the program's RenderCamera of each
    masks: list          # [H, W] per view
    targets: list        # [H, W, 3] per view
    embs: object         # [2, L, D] (unconditional, conditional)
    draws: list          # [(t [1], noise [1, h, w, 4])] of the first steps
    extent: float
    bg_color: object


def setup(run) -> Inputs:
    torch = run.torch
    from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera
    cfg, tr = run.config, run.traffic
    scene, bg_fields, n_new = insertion.insertion_scene(
        cfg, run.seed_for("scene"), run.seed_for("box"), run.device)
    cams = scene_mod.orbit_cameras(
        tr["views"], tr["yaw_span"], tr["distance"], tr["width"],
        tr["height"], tr["fovx"], tr["fovy"], run.seed_for("views"),
        run.device)
    pcams = [RenderCamera(world_view=c.world_view, full_proj=c.full_proj,
                          campos=c.campos, tan_fovx=c.tan_fovx,
                          tan_fovy=c.tan_fovy, width=c.width,
                          height=c.height) for c in cams]
    bg_color = torch.zeros(3, device=run.device)
    set_compute(torch, REFERENCE_COMPUTE)
    target = scene_mod.perturb(bg_fields, run.seed_for("targets"),
                               run.device)
    with torch.no_grad():
        masks, targets = insertion.masks_and_targets(
            cfg, bg_fields, target, cams,
            lambda f, c: ref_gs.render(f, c, bg_color, cfg["sh_degree"]))
    del bg_fields, target
    g = run.generator("text")
    embs = torch.randn((2, cfg["text_tokens"], cfg["unet"]["context_dim"]),
                       generator=g, device=run.device)
    lat = cfg["sds_size"] // 8
    t_lo, t_hi = cfg["t_range"]
    g = run.generator("draws")
    draws = [(torch.randint(t_lo, t_hi + 1, (1,), generator=g,
                            device=run.device),
              torch.randn((1, lat, lat, 4), generator=g, device=run.device))
             for _ in range(tr["warm_steps"])]
    return Inputs(scene, n_new, cams, pcams, masks, targets, embs, draws,
                  scene_mod.camera_extent(cams), bg_color)


def program_params(run, inp: Inputs):
    from multiview_inpaint_tpu_torch.gs.gaussians import GaussianParams
    n = inp.scene["xyz"].shape[0]
    return GaussianParams(
        live=run.torch.ones(n, dtype=run.torch.bool, device=run.device),
        **{f: v.clone() for f, v in inp.scene.items()})


def load_guidance(run, spec):
    """The program's prior with the run's seeded weights, through
    ``make_guidance``."""
    from multiview_inpaint_tpu_torch.diffusion import checkpoint
    from multiview_inpaint_tpu_torch.diffusion.unet2d import (UNet2D,
                                                              UNet2DConfig)
    from multiview_inpaint_tpu_torch.diffusion.vae import (AutoencoderKL,
                                                           VAEConfig)
    from multiview_inpaint_tpu_torch.pipelines.sds_train import make_guidance
    cfg = run.config
    unet = UNet2D(UNet2DConfig(**_tuples(cfg["unet"])), device=run.device)
    vae = AutoencoderKL(VAEConfig(**_tuples(cfg["vae"])),
                        video_decoder=False, device=run.device)
    sd = seeded_weights(run, spec)
    for module, name in ((unet, "unet"), (vae, "vae")):
        missing, unexpected = checkpoint.import_state_dict(
            module, sd, checkpoint.PREFIXES[name])
        if missing or unexpected:
            raise RuntimeError(f"weights do not fit the {name}: "
                               f"{missing[:4]} {unexpected[:4]}")
    del sd
    return make_guidance(unet, vae, cfg["guidance_scale"])


def image_grad(guidance, image, mask, embs, t, noise):
    """The gradient of ``guidance``'s SDS loss with respect to ``image``
    (zero where the loss does not depend on it)."""
    import torch
    x = image.detach().clone().requires_grad_(True)
    loss = guidance.train_step(x, mask, embs, t=t, noise=noise)
    if not loss.requires_grad:
        return torch.zeros_like(x)
    (g,) = torch.autograd.grad(loss, x)
    return g


def split(leaves: dict, n: int) -> dict:
    """Each leaf as two: the scene's rows and the box's ``n`` new rows
    (``box.<field>``). The new rows are isotropic, so their rotation's
    gradient is round-off alone, and Adam moves them by it."""
    out = {k: v[:-n] for k, v in leaves.items()}
    out.update({"box." + k: v[-n:] for k, v in leaves.items()})
    return out


def program_first_steps(run, inp: Inputs, guidance, params):
    """The program's first ``warm_steps`` steps from ``params``: (the
    state they leave, the readings the check compares)."""
    from multiview_inpaint_tpu_torch.models import gs_trainer, sds_trainer
    cfg = run.config
    state = gs_trainer.init_state(params)
    seen = {}
    inner = guidance.train_step

    def spy(image, mask, text_embs, **kw):
        if not seen:
            seen.update(image=image.detach().clone(), mask=mask)
        return inner(image, mask, text_embs, **kw)

    prog = {"losses": []}
    guidance.train_step = spy
    try:
        for i, (t, noise) in enumerate(inp.draws):
            state, m = sds_trainer.sds_train_step(
                state, inp.pcams[i], inp.targets[i], inp.masks[i],
                inp.bg_color, gs_trainer.INPAINT_OPT, guidance, inp.embs,
                spatial_lr_scale=inp.extent, sh_degree=cfg["sh_degree"],
                sds_weight=cfg["sds_weight"], sds_size=cfg["sds_size"],
                t=t, noise=noise)
            prog["losses"].append((float(m.sds_loss), float(m.loss)))
            if i == 0:
                grads = {k: state.mu[k] / 0.1 for k in FIELDS}
                prog["box_grad_norms"] = norms(
                    {k: g[-inp.new_rows:] for k, g in grads.items()})
    finally:
        del guidance.train_step
    prog["change_norms"] = norms(split(
        {k: getattr(state.params, k) - inp.scene[k] for k in FIELDS},
        inp.new_rows))
    t0, noise0 = inp.draws[0]
    prog["image"], prog["mask"] = seen["image"], seen["mask"]
    prog["sds_grad"] = image_grad(guidance, seen["image"], seen["mask"],
                                  inp.embs, t0, noise0)
    return state, prog


def reference_prior(run, spec, lowp=False):
    """The float32 reference prior with the run's seeded weights (built on
    the meta device, so that only the weights are written); ``lowp``: the
    control, its parameters and activations in bfloat16."""
    torch = run.torch
    cfg = run.config
    with torch.device("meta"):
        prior = ref_prior.Prior(*configs(cfg), cfg["guidance_scale"])
    prior.to_empty(device=run.device)
    prior.load(seeded_weights(run, spec))
    prior.requires_grad_(False)
    if lowp:
        prior.to(torch.bfloat16)
    return prior


def reference_readings(run, inp: Inputs, spec, image, mask, lowp=False):
    torch = run.torch
    cfg = run.config
    set_compute(torch, REFERENCE_COMPUTE)
    prior = reference_prior(run, spec, lowp)
    out = ref_step.sds_steps(prior, inp.scene, inp.cams, inp.targets,
                             inp.masks, inp.bg_color, cfg["optimization"],
                             inp.extent, cfg["sh_degree"], inp.embs,
                             inp.draws, cfg["sds_weight"], cfg["sds_size"])
    t0, noise0 = inp.draws[0]
    g = prior.image_grad(image, mask, inp.embs, t0, noise0)
    return {"losses": out["losses"],
            "grad_norms": norms(split(out["grads"], inp.new_rows)),
            "box_grad_norms": norms({k: v[-inp.new_rows:]
                                     for k, v in out["grads"].items()}),
            "change_norms": norms(split(
                {k: out["fields"][k] - inp.scene[k] for k in FIELDS},
                inp.new_rows)),
            "sds_grad": g}


def gaps(prog: dict, want: dict) -> dict:
    import statistics
    floor = statistics.median(want["grad_norms"].values())
    moved = [k for k, v in want["grad_norms"].items() if v >= 1e-3 * floor]
    losses = [(a, b) for p, w in zip(prog["losses"], want["losses"])
              for a, b in zip(p, w)]
    return {"sds_grad_rms": rel_rms(prog["sds_grad"], want["sds_grad"]),
            "loss_gap": max(abs(a - b) / abs(b) for a, b in losses),
            "box_grad_gap": leaf_gap(prog["box_grad_norms"],
                                     want["box_grad_norms"]),
            "change_gap": leaf_gap(prog["change_norms"],
                                   want["change_norms"], moved)}


def compare(run, prog, want) -> bool:
    limits = run.traffic["limits"]
    return all([run.compare(k, v, limits[k])
                for k, v in gaps(prog, want).items() if k in limits])


FAULTS = ("cond_left_out", "encoder_cut", "state_unchanged")


@contextlib.contextmanager
def planted(guidance, which: str):
    """One of ``FAULTS`` planted in the program while the block runs: two
    in ``guidance`` (``faults``); ``"state_unchanged"``, the SDS step's
    Adam update never applied."""
    from multiview_inpaint_tpu_torch.models import sds_trainer
    adam = sds_trainer.apply_adam
    if which == "state_unchanged":
        sds_trainer.apply_adam = lambda state, *a, **k: (
            state, state.params.xyz.new_zeros(()))
    else:
        faults(guidance, which)
    try:
        yield
    finally:
        sds_trainer.apply_adam = adam


def faults(guidance, which: str):
    """Plant one fault in ``guidance``: ``"cond_left_out"``, the CFG
    batch's conditional half left out (eps_hat = eps_u); or
    ``"encoder_cut"``, the encoder's backward cut (latents detached)."""
    if which == "cond_left_out":
        eps_model = guidance.eps_model

        def eps_cfg(x9, t, text_embs):
            b = x9.shape[0]
            return eps_model(x9, t, text_embs[0:1].expand(b, -1, -1))
        guidance._eps_cfg = eps_cfg
    elif which == "encoder_cut":
        encode = guidance.vae_encode
        guidance.vae_encode = lambda img: encode(img).detach()
    else:
        raise ValueError(which)


def calibrate(run):
    """The readings the limits are set from, for one seed: the program's
    first steps, the control's (the reference with its prior, the UNet2D
    and the encoder, in bfloat16) and the program's under each of
    ``FAULTS``, each against the reference."""
    torch = run.torch
    cfg = run.config
    spec = weight_list(cfg)
    inp = setup(run)
    out = {}
    for fault in (None,) + FAULTS:
        guidance = load_guidance(run, spec)
        set_compute(torch, cfg["compute"])
        with (planted(guidance, fault) if fault
              else contextlib.nullcontext()):
            _, prog = program_first_steps(run, inp, guidance,
                                          program_params(run, inp))
        out[fault or "program"] = prog
        del guidance
        run.close_program()
    sound = out["program"]
    want = reference_readings(run, inp, spec, sound["image"], sound["mask"])
    run.close_program()
    control = reference_readings(run, inp, spec, sound["image"],
                                 sound["mask"], lowp=True)
    res = {k: gaps(v, want) for k, v in out.items()}
    res["control"] = gaps(control, want)
    return res


def run(run):
    torch = run.torch
    from multiview_inpaint_tpu_torch import telemetry
    from multiview_inpaint_tpu_torch.models import gs_trainer, sds_trainer
    # a checkout whose program has no make_guidance stops here, at once
    from multiview_inpaint_tpu_torch.pipelines.sds_train import (  # noqa
        make_guidance)
    cfg, tr = run.config, run.traffic
    spec = weight_list(cfg)
    if run.trace:
        from port_bench.counts.sds_flops import sds_flops
        sds_flops(cfg)   # the mfu reader's, counted in a first run
    run.note("the prior's key list")
    inp = setup(run)
    run.sync()
    run.note("scene, views, masks and targets")
    guidance = load_guidance(run, spec)
    run.sync()
    run.note("prior built on the card, seeded weights loaded")
    set_compute(torch, cfg["compute"])
    if run.trace:
        sc.wrap_kernels(run, tr["captured_frames"])
        wrap_attention(run)
    state, prog = program_first_steps(run, inp, guidance,
                                      program_params(run, inp))
    run.note("first steps")
    views = len(inp.pcams)
    gen = run.generator("window")
    spans_on = run.trace

    def step(i):
        nonlocal state, spans_on
        if spans_on and run.tracing:
            telemetry.disable()
            spans_on = False
        v = (tr["warm_steps"] + i) % views
        state, _ = sds_trainer.sds_train_step(
            state, inp.pcams[v], inp.targets[v], inp.masks[v],
            inp.bg_color, gs_trainer.INPAINT_OPT, guidance, inp.embs,
            spatial_lr_scale=inp.extent, sh_degree=cfg["sh_degree"],
            sds_weight=cfg["sds_weight"], sds_size=cfg["sds_size"],
            generator=gen)

    if run.trace:
        telemetry.reset()
        telemetry.enable(device_events=run.cuda)
    try:
        units, window_s = run.window(step, traced=tr["traced_steps"])
    finally:
        telemetry.disable()
    print(f"window: {units} steps in {window_s!r} s", file=sys.stderr)
    if run.trace:
        run.readings.captures["telemetry"] = telemetry.snapshot()
        telemetry.reset()
    run.readings.captures["pixels"] = tr["width"] * tr["height"]
    run.readings.captures["splats"] = inp.scene["xyz"].shape[0]
    del state, guidance
    run.close_program()
    want = reference_readings(run, inp, spec, prog["image"], prog["mask"])
    run.note("reference steps")
    ok = compare(run, prog, want)
    return {"correct": ok, "attempted": units, "failed": 0 if ok else 1,
            "end_to_end": {"gs_step_ms": window_s * 1e3 / units,
                           "setup_s": run.setup_s}}
