"""Main path 10 of ``chip_smoke.py`` (slice 9a: the blended and inversion
samplers, divide_test and the image-to-video demo server) alone, on one
NVIDIA GPU.

    python3 scripts/port_slice9a.py

Builds the kernels, then runs the phases of main path 10 as
``chip_smoke.py`` runs them: the tiny engine's samplers on the card
against the CPU, ``svd_test --sampling blended --dump_latents`` and
``--sampling inversion`` at full width with their background checks and
planted faults, K4 at the inversion's batch-14 shapes and on the f32
operands of the uncontrolled UNet, ``divide_test`` on both grids, and
the ``demo_app`` server with its requests and the f32 denoiser
evaluation through K4. Any failed check exits non-zero. Prints the
phases' lines (with the card's name and power limit), then the seconds
of each phase. Imports the port only (no JAX).
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import torch

    import chip_smoke as cs

    t_all = time.perf_counter()
    card = cs.phase_card(torch)
    cs.phase_build()
    marks = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        marks[name] = round(time.perf_counter() - t0, 2)
        return out

    timed("engine", cs.phase_sampling_engine, torch, card)
    runs = {mode: timed(mode, cs.phase_svd_sampling, torch, card, mode)
            for mode in ("blended", "inversion")}
    torch.cuda.empty_cache()
    timed("k4", cs.phase_k4, torch, card, cs.K4_10_SHAPES, "15d")
    timed("divide_test", cs.phase_divide_test, card, runs)
    timed("demo", cs.phase_demo_app, torch, card)
    print(f"[slice 9a] phases (s) {marks}, all "
          f"{time.perf_counter() - t_all:.1f} s | {card}", flush=True)


if __name__ == "__main__":
    main()
