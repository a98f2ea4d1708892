"""Main path 7 of ``chip_smoke.py`` (slice 7: SDS, the 2D priors, depth
hints) alone, on one NVIDIA GPU.

    python3 scripts/port_slice7.py

Builds the kernels, writes main path 5's workspace (the bench COLMAP
scene, the 2M-gaussian PLY, the registry and both boxes) and runs the
``gen_seq`` and ``delete`` CLIs on it without main path 5's checks, then
the phases of main path 7 as ``chip_smoke.py`` runs them: the random
SD-2-inpainting-width prior written and read back, K4 at the UNet2D's
shapes, one UNet2D evaluation through K4 against the plain attention,
one SDS step at 1080p with K1-K3 held against their plain versions, the
``sds_train`` CLI, ``gen_seq --sds`` and ``gen_depth`` (DPT and rendered)
and ``ctrl_inpaint`` at full width. Any failed check exits non-zero.
Prints the phases' lines (with the card's name and power limit), then
the seconds of each phase. Imports the port only (no JAX).
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import torch

    import chip_smoke as cs
    from multiview_inpaint_tpu_torch.pipelines import delete, gen_seq

    t_all = time.perf_counter()
    card = cs.phase_card(torch)
    cs.phase_build()
    s = cs.phase_stage1_setup(card)
    t = time.perf_counter()
    gen_seq.main(cs._stage1_argv(s))
    delete.main(["-m", s["model"], "--box", s["del_box"], "--iteration",
                 "1", "--device", cs.DEVICE])
    print(f"[slice 7] gen_seq + delete {time.perf_counter() - t:.1f} s",
          flush=True)
    marks = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        marks[name] = round(time.perf_counter() - t0, 2)
        return out

    sw = timed("setup", cs.phase_slice7_setup, torch, card, s)
    timed("k4", cs.phase_k4, torch, card, cs.K4_2D_SHAPES, "30")
    timed("eval", cs.phase_unet2d_eval, torch, card, sw)
    threshold, _ = timed("step", cs.phase_sds_step, torch, card, s, sw)
    del sw["guidance"]
    torch.cuda.empty_cache()
    _, sds_out = timed("sds_train", cs.phase_sds_train, torch, card, s, sw,
                       threshold)
    timed("depth", cs.phase_sds_depth, torch, card, s, sds_out)
    timed("ctrl", cs.phase_ctrl_inpaint, torch, card, s, sw)
    os.remove(sw["sd"])
    print(f"[slice 7] phases (s) {marks}, all "
          f"{time.perf_counter() - t_all:.1f} s | {card}", flush=True)


if __name__ == "__main__":
    main()
