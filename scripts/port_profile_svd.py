"""Profile one full-width SVD sampler step, or train step, of the port on
the GPU.

    python scripts/port_profile_svd.py [--trace_dir build/profile_svd]
    python scripts/port_profile_svd.py --step sharded
    python scripts/port_profile_svd.py --step train

Builds the full-width engine as ``chip_smoke.py``'s main path 3 does
(``init_engine`` with bf16 weights on the card, every all-zero parameter
moved), conditions it on a seeded batch (14 frames at 512x384), times
three guided denoiser evaluations at sigma_max with CUDA events (one per
sampler step, CFG batch 28), then traces three more with
``torch.profiler`` and prints one JSON line: the card, the ms per
evaluation, the trace window, the device's busy and idle share over it,
device time per evaluation by kind of kernel (K4, matrix products,
convolutions, layout conversions, normalisation, softmax, copies,
elementwise, the rest), the top kernels by name, and the card's SM clock,
power draw and temperature before and after. The chrome trace is
``<trace_dir>/trace.json``. Imports the port only (no JAX).

``--step sharded`` traces the same evaluation through
``make_frame_sharded_denoiser`` over NCCL at world size 1 (main path 12's
frame-sharded sampling), adds NCCL to the kinds and the host time of the
collective calls (``c10d``/``nccl`` CPU ops) per evaluation.

``--step train`` does the same for ``chip_smoke.py``'s main path 4: one
ControlNet train step of ``svd_train`` at full width (one video of 14
frames, bf16 weights and compute, Adam and the EMA update), three timed
and three traced, and adds K5 to the kinds, the step's split into loss
forward, backward and optimizer + EMA (CUDA events, mean of three) and
the peak device memory.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVALS = 3
# Lower-case kernel-name fragments of each kind, first match wins.
KINDS = (("nccl", ("nccl",)),
         ("K4", ("flash_fwd_kernel",)),
         ("K5", ("flash_bwd_",)),
         ("layout", ("nchwtonhwc", "nhwctonchw")),
         ("conv", ("fprop", "conv", "winograd", "implicit_gemm")),
         ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
         ("norm", ("norm", "moments")),
         ("softmax", ("softmax",)),
         ("copy", ("copy",)),
         ("elementwise", ("elementwise",)))


def kind(name: str) -> str:
    low = name.lower()
    for k, frags in KINDS:
        if any(f in low for f in frags):
            return k
    return "other"


def clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trace_dir",
                   default=os.path.join(REPO, "build", "profile_svd"))
    p.add_argument("--step", choices=("sample", "sharded", "train"),
                   default="sample")
    args = p.parse_args()
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch

    import chip_smoke
    from port_profile_train import summarise

    from multiview_inpaint_tpu_torch.diffusion.engine import (EngineConfig,
                                                              init_engine)
    from multiview_inpaint_tpu_torch.parallel import svd_data_parallel as dp

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = chip_smoke.phase_card(torch)
    chip_smoke.phase_build()
    frames, h, w = (chip_smoke.SVD_FRAMES, chip_smoke.SVD_H,
                    chip_smoke.SVD_W)
    eng = init_engine(EngineConfig(num_frames=frames,
                                   compute_dtype="bfloat16"),
                      seed=0, device="cuda", param_dtype="bfloat16")
    chip_smoke.perturb_zero_params(torch, eng, 7)
    batch = chip_smoke._svd_batch(torch, frames, h, w, "cuda", 0)
    cond = eng.prepare_cond(batch)
    uc = eng.prepare_cond(batch, unconditional=True)
    uc["control_hint"] = cond["control_hint"]
    sigma = torch.full((frames,), eng.cfg.sigma_max, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((frames, h // 8, w // 8, 4), generator=gen,
                    device="cuda") * (1 + eng.cfg.sigma_max ** 2) ** 0.5
    extra = {}
    if args.step in ("sample", "sharded"):
        gx, gs, gc = eng.guider.prepare(x, sigma, cond, uc)
        denoise = eng.denoise_fn()
        if args.step == "sharded":
            from multiview_inpaint_tpu_torch.parallel import mesh
            from multiview_inpaint_tpu_torch.parallel import (
                svd_inference_parallel as sp)
            mesh.init(0, 1, f"tcp://127.0.0.1:{chip_smoke._free_port()}",
                      "cuda")
            denoise = sp.make_frame_sharded_denoiser(eng)

        def step():
            return denoise(gx, gs, gc)
    else:
        params = dp.trainable_params(eng)
        opt = dp.build_optimizer(1e-4)
        state = opt.init(params)
        ema = {k: p.detach().clone() for k, p in params.items()}
        lat = x[None] / (1 + eng.cfg.sigma_max ** 2) ** 0.5
        cond_b = {k: v[None] for k, v in cond.items()}
        train_step = dp.make_train_step(eng, opt, params, ema_decay=0.9999)

        def step():
            return train_step(state, ema, lat, cond_b, generator=gen)

        def parts():
            lat_f, cond_f, _ = dp.flatten_videos(lat, cond_b)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss = eng.loss(lat_f, cond_f, generator=gen)
            ev[1].record()
            grads = torch.autograd.grad(loss, list(params.values()))
            ev[2].record()
            opt.step(params, dict(zip(params, grads)), state)
            dp.ema_update(ema, params, 0.9999)
            ev[3].record()
            torch.cuda.synchronize()
            return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

        step()                               # warm-up before the split
        torch.cuda.reset_peak_memory_stats()
        split = [parts() for _ in range(EVALS)]
        extra = {"split_ms_mean": dict(zip(
                     ("loss_forward", "backward", "adam_ema"),
                     (sum(c) / EVALS for c in zip(*split)))),
                 "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}

    step()                                   # warm-up (cuDNN, cuBLAS)
    before = clocks()
    ms = chip_smoke.cuda_ms(torch, step, EVALS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EVALS):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / EVALS
    prof_dir = args.trace_dir
    shutil.rmtree(prof_dir, ignore_errors=True)
    os.makedirs(prof_dir)
    trace = os.path.join(prof_dir, "trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(EVALS):
            step()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    after = clocks()
    out = summarise(trace, top=25)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    by_kind = collections.Counter()
    coll_ms = 0.0
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            by_kind[kind(e["name"])] += e["dur"] / 1e3 / EVALS
        elif (e.get("cat") == "cpu_op" and "dur" in e
              and e["name"].startswith(("c10d::", "nccl:"))):
            coll_ms += e["dur"] / 1e3 / EVALS
    if args.step == "sharded":
        extra["collective_host_ms_per_eval"] = coll_ms
        torch.distributed.destroy_process_group()
    print(json.dumps({"card": card, "step": args.step,
                      "sm_clock_power_temp": [before, after],
                      "ms_per_eval_cuda_events": ms,
                      "ms_per_eval_host_clock": host_ms,
                      "evals_traced": EVALS,
                      "kernel_ms_per_eval_by_kind": dict(by_kind), **extra,
                      **out}))


if __name__ == "__main__":
    main()
