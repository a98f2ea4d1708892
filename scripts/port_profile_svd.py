"""Profile one full-width SVD sampler step of the port on the GPU.

    python scripts/port_profile_svd.py [--trace_dir build/profile_svd]

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
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVALS = 3
# Lower-case kernel-name fragments of each kind, first match wins.
KINDS = (("K4", ("flash_fwd_kernel",)),
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
    args = p.parse_args()
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch

    import chip_smoke
    from port_profile_train import summarise

    from multiview_inpaint_tpu_torch.diffusion.engine import (EngineConfig,
                                                              init_engine)

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
    gx, gs, gc = eng.guider.prepare(x, sigma, cond, uc)
    denoise = eng.denoise_fn()

    def step():
        return denoise(gx, gs, gc)

    step()                                   # warm-up (cuDNN, cuBLAS)
    before = clocks()
    ms = chip_smoke.cuda_ms(torch, step, EVALS)
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
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            by_kind[kind(e["name"])] += e["dur"] / 1e3 / EVALS
    print(json.dumps({"card": card, "sm_clock_power_temp": [before, after],
                      "ms_per_eval_cuda_events": ms,
                      "evals_traced": EVALS,
                      "kernel_ms_per_eval_by_kind": dict(by_kind), **out}))


if __name__ == "__main__":
    main()
