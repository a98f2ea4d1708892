"""Main path 11 of ``chip_smoke.py`` (slice 10: band mode, the distributed
GS paths at world size 1, native PNG decoding and the live view) alone,
on one NVIDIA GPU.

    python3 scripts/port_slice10.py

Builds the kernels, writes main path 5's stage-1 workspace and runs its
``gen_seq`` CLI (phases 20-21, for the PNGs that native_io decodes),
then runs main path 11's phases as ``chip_smoke.py`` runs them: the
big2m 1080p frame as 4 bands with K2 in band mode against its plain
version, the ball2m-train step as 4 bands with K3 in band mode, the
distributed paths over NCCL at world size 1, and native_io with the
``train_gs --live_view`` run (main path 2's scene is written when it is
missing). Any failed check exits non-zero. Prints the phases' lines (with
the card's name and power limit), then the seconds of each phase.
Imports the port only (no JAX).
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import torch

    import chip_smoke as cs
    from multiview_inpaint_tpu_torch.utils import synthetic

    t_all = time.perf_counter()
    card = cs.phase_card(torch)
    cs.phase_build()
    marks = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        marks[name] = round(time.perf_counter() - t0, 2)
        return out

    stage1 = timed("stage1", cs.phase_stage1_setup, card)
    timed("gen_seq", cs.phase_gen_seq, torch, card, stage1)
    big = synthetic.make_big_scene(cs.BIG_N, device=cs.DEVICE)
    timed("band_frame", cs.phase_band_frame, torch, card, big)
    cell = cs._step_cell(torch)
    timed("band_step", cs.phase_band_step, torch, card, cell)
    timed("distributed", cs.phase_distributed, torch, card, big, cell)
    del big, cell
    torch.cuda.empty_cache()
    timed("host_parts", cs.phase_host_parts, torch, card, stage1)
    print(f"[slice 10] phases (s) {marks}, all "
          f"{time.perf_counter() - t_all:.1f} s | {card}", flush=True)


if __name__ == "__main__":
    main()
