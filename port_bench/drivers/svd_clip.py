"""Driver of back-to-back inpainted clips through the port's SVDEngine.

Set-up: the engine (``diffusion.engine.init_engine``) at the
configuration's widths, its weights replaced by the benchmark's seeded
ones (``inputs.weights``), then one short clip of ``warm_steps`` steps,
which builds the kernels and warms every shape of the window. Each clip
of the window, as ``pipelines/svd_test.run`` processes one scene x
candidate x mode: fresh seeded inputs (``inputs.clip``), the
conditioning of c and uc (``prepare_cond``), ``num_steps`` Euler-EDM
steps at CFG batch 2 x frames (``sample``, the noise injected), the
temporal VAE decode (``decode_first_stage``); the frames stay on the
card. The window closes at the end of the first clip that ends at or
after ``--seconds``. For each clip, standard error gets the host seconds
to queue its work and to finish it, and the process's CPU seconds and
the seconds of full garbage collections in that time: where the CPU
seconds come near the clip's, the host paces the card.

The check: one clip of the window, drawn from the seed, is run again by
the float32 reference (``reference/svd``; its matrix products and
convolutions in TF32, ~8x finer than the program's bfloat16) from the
same inputs and weights once the program is freed, and the relative rms
of the decoded frames is held to the traffic's limit.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

from port_bench.counts.svd_flops import clip_flops
from port_bench.inputs.clip import clip_inputs
from port_bench.inputs.weights import seeded
from port_bench.reference.svd import model as ref_model


def engine_config(cfg: dict, traffic: dict):
    from multiview_inpaint_tpu_torch.diffusion.clip_vit import ViTConfig
    from multiview_inpaint_tpu_torch.diffusion.engine import EngineConfig
    from multiview_inpaint_tpu_torch.diffusion.unet import UNetConfig
    from multiview_inpaint_tpu_torch.diffusion.vae import VAEConfig
    tup = ref_model._tuples
    return EngineConfig(
        unet=UNetConfig(**tup(cfg["unet"])), vae=VAEConfig(**tup(cfg["vae"])),
        vit=ViTConfig(**tup(cfg["vit"])), hint_channels=cfg["hint_channels"],
        num_frames=cfg["num_frames"],
        num_steps=traffic.get("num_steps", EngineConfig.num_steps),
        sigma_max=cfg["sigma_max"], sigma_min=cfg["sigma_min"],
        cfg_min=cfg["cfg_min"], cfg_max=cfg["cfg_max"],
        control_scales=cfg["control_scales"],
        compute_dtype=cfg["compute_dtype"])


def weight_list(cfg: dict) -> list:
    """The reference's (key, shape) list of ``cfg``, worked out on the
    meta device once per checkout (``harness.cache``)."""
    from port_bench.harness import cache
    key = [cfg, cache.sources_key(os.path.dirname(ref_model.__file__))]
    spec = cache.memo("svd-weights", key,
                      lambda: ref_model.weight_spec(cfg))
    return [(k, tuple(shape)) for k, shape in spec]


def seeded_weights(run, spec) -> dict:
    """The run's weights in the reference checkpoint's key space."""
    return seeded(spec, run.seed_for("weights"), run.device,
                  ref_model.storage_dtype)


def load_engine(run, cfg, traffic, spec):
    """The port's engine with the run's seeded weights."""
    torch = run.torch
    from multiview_inpaint_tpu_torch.diffusion import engine as E
    eng = E.init_engine(engine_config(cfg, traffic), seed=0,
                        device=run.device,
                        param_dtype=getattr(torch, cfg["param_dtype"]))
    report = eng.load_reference_state_dict(seeded_weights(run, spec))
    bad = {k: (len(m), len(u)) for k, (m, u) in report.items() if m or u}
    if bad or set(report) != set(ref_model.PREFIXES):
        raise RuntimeError(f"weights do not fit the engine: {bad}")
    return eng


def wrap_attention(run):
    """Keep (batch, heads, length, head dim, element bytes) of each K4
    call made while the profiler is on."""
    from multiview_inpaint_tpu_torch.diffusion import attention_op
    calls = run.readings.captures.setdefault("k4", [])
    inner = attention_op.flash_attention

    def flash_attention(q, k, v, heads, scale):
        if run.tracing:
            b, t, hd = q.shape
            calls.append((b, heads, t, hd // heads, q.element_size()))
        return inner(q, k, v, heads, scale)

    attention_op.flash_attention = flash_attention


@contextlib.contextmanager
def tf32(torch):
    """TF32 products and convolutions inside the block only."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = True
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.allow_tf32 = p


def reference_model(run, cfg, spec):
    """The float32 reference with the run's seeded weights (built on the
    meta device, so that only the weights are written)."""
    torch = run.torch
    with torch.device("meta"):
        ref = ref_model.ReferenceSVD(cfg)
    ref.to_empty(device=run.device)
    ref.load(seeded_weights(run, spec))
    return ref


class HostCounters:
    """The process's CPU seconds and the seconds spent in full
    (generation 2) garbage collections, inside the ``with`` block."""

    def __enter__(self):
        import gc
        self.gc_s, self._gc_t0 = 0.0, None
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._gc)
        return False

    def _gc(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0

    def read(self) -> tuple:
        return time.process_time(), self.gc_s


def rel_rms(a, b) -> float:
    d = (a.float() - b.float()).pow(2).mean().sqrt()
    return float(d / b.float().pow(2).mean().sqrt())


def program_clip(run, eng, i, num_steps):
    """Clip ``i`` of the run through the program: its decoded frames."""
    cfg = run.config
    t, (h, w) = cfg["num_frames"], cfg["resolution"]
    inputs = clip_inputs(run.seed_for("clip", i), t, h, w, run.device)
    batch = inputs["batch"]
    with run.spans("cond"):
        c = eng.prepare_cond(batch, aug_noise=inputs["aug_noise"])
        uc = eng.prepare_cond(batch, unconditional=True)
        uc["control_hint"] = c["control_hint"]
    with run.spans("denoise"):
        z = eng.sample(c, uc, latent_shape=(t, h // 8, w // 8, 4),
                       noise=inputs["noise"], num_steps=num_steps)
    with run.spans("decode"):
        return eng.decode_first_stage(z, timesteps=t)


def reference_clip(run, spec, i, lowp=False):
    """Clip ``i`` through the float32 reference, or with ``lowp`` through
    the control (its denoiser's products in float8)."""
    cfg = run.config
    t, (h, w) = cfg["num_frames"], cfg["resolution"]
    ref = reference_model(run, cfg, spec)
    if lowp:
        from port_bench.reference.svd.lowp import emulate_fp8
        emulate_fp8(ref.unet)
        emulate_fp8(ref.controlnet)
    inputs = clip_inputs(run.seed_for("clip", i), t, h, w, run.device)
    with tf32(run.torch):
        return ref.clip_frames(inputs, run.traffic["num_steps"])


def calibrate(run):
    """The readings the limit is set from, for one seed: clip 0 of the
    program and of the control (the reference with its denoiser's
    products in float8), each against the reference."""
    torch = run.torch
    spec = weight_list(run.config)
    eng = load_engine(run, run.config, run.traffic, spec)
    with torch.no_grad():
        frames = program_clip(run, eng, 0, run.traffic["num_steps"])
    del eng
    run.close_program()
    want = reference_clip(run, spec, 0)
    run.close_program()
    control = reference_clip(run, spec, 0, lowp=True)
    return {"program": {"frames_rel_rms": rel_rms(frames, want)},
            "control": {"frames_rel_rms": rel_rms(control, want)}}


def run(run):
    torch = run.torch
    cfg, traffic = run.config, run.traffic
    steps = traffic["num_steps"]
    spec = weight_list(cfg)
    clip_flops(cfg, steps)   # the mfu reader's, counted in a first run
    run.note("the weights' key list and the clip's FLOPs")
    eng = load_engine(run, cfg, traffic, spec)
    run.note("engine built on the card, seeded weights loaded")
    if run.trace:
        wrap_attention(run)
    run.readings.captures["steps"] = steps
    with torch.no_grad():
        run.spans.enabled = False
        program_clip(run, eng, -1, traffic["warm_steps"])
        run.sync()
        run.note("warm clip")
        run.spans.enabled = run.trace
        outputs = []

        def clip(i):
            t0, before = time.perf_counter(), host.read()
            outputs.append(program_clip(run, eng, i, steps))
            queued = time.perf_counter() - t0
            run.sync()
            cpu, gc_s = (b - a for a, b in zip(before, host.read()))
            print(f"clip {i}: queued in {queued:.3f} s, done in "
                  f"{time.perf_counter() - t0:.3f} s; process cpu "
                  f"{cpu:.3f} s, full gc {gc_s:.3f} s", file=sys.stderr)

        with HostCounters() as host:
            units, window_s = run.window(clip, traced=1)
    print(f"window: {units} clips in {window_s!r} s", file=sys.stderr)
    pick = int(torch.randint(units, (1,), generator=torch.Generator()
                             .manual_seed(run.seed_for("check"))))
    frames = outputs[pick]
    del eng, outputs
    run.close_program()
    want = reference_clip(run, spec, pick)
    run.note("reference clip")
    ok = run.compare("frames_rel_rms", rel_rms(frames, want),
                     traffic["limits"]["frames_rel_rms"])
    return {"correct": ok, "attempted": units, "failed": 0 if ok else 1,
            "end_to_end": {"clip_s": window_s / units,
                           "setup_s": run.setup_s}}
