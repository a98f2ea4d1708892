"""Main path 6 of ``chip_smoke.py`` (stage 2) alone, on one NVIDIA GPU.

    python3 scripts/port_stage2.py

Builds the kernels, writes main path 5's workspace (the bench COLMAP
scene, the 2M-gaussian PLY, the registry and both boxes) and runs the
``gen_seq`` and ``delete`` CLIs on it without main path 5's checks, then
the phases of main path 6 as ``chip_smoke.py`` runs them: the stand-in
inpainted frames, ``seg_masks --auto --propagate``, ``seg_masks
--ground`` at full width, one stage-2 step of each kind with K1-K3 held
against their plain versions, and the ``inpaint_rec`` CLI. Any failed
check exits non-zero. Prints the phases' lines (with the card's name and
power limit), then the seconds of each phase and the kernels' records of
both step shapes. Imports the port only (no JAX); about 80 s of command
time on an H100.
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
    print(f"[stage 2] gen_seq + delete {time.perf_counter() - t:.1f} s",
          flush=True)
    marks = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        marks[name] = round(time.perf_counter() - t0, 2)
        return out

    visible, fov = timed("frames", cs.phase_stage2_frames, torch, card, s)
    timed("auto", cs.phase_seg_auto, torch, card, s, visible, fov)
    timed("ground", cs.phase_seg_ground, torch, card, s)
    threshold, rec = timed("step", cs.phase_stage2_step, torch, card, s)
    launches = timed("rec", cs.phase_inpaint_rec, torch, card, s, threshold)
    print(f"[stage 2] phases (s) {marks}, all "
          f"{time.perf_counter() - t_all:.1f} s | kernels {rec} | launches "
          f"{launches} | {card}", flush=True)


if __name__ == "__main__":
    main()
