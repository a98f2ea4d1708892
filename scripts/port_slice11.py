"""Main path 12 of ``chip_smoke.py`` (slice 11: frame-sharded SVD
sampling, ``svd_test --shard_frames`` and the ControlNet DDP step, at
world size 1 over NCCL) alone, on one NVIDIA GPU.

    python3 scripts/port_slice11.py

Builds the kernels, runs main path 3 (the ``svd_test`` CLI at full width,
for its engine, conditioning and frames), then main path 12's phases as
``chip_smoke.py`` runs them: the frame-sharded forward and 25-step clip
on main path 3's engine against ``apply_model`` and ``engine.sample``,
the ``svd_test --shard_frames`` CLI against main path 3's frames, main
path 4 (the ``svd_train`` CLI, for its engine) and the DDP steps against
``make_train_step``. Any failed check exits non-zero. Prints the phases'
lines (with the card's name and power limit), then the seconds of each
phase. Imports the port only (no JAX).
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

    _, probe = timed("svd_main", cs.phase_svd_main, torch, card)
    timed("frame_sharded", cs.phase_frame_sharded, torch, card, probe)
    del probe
    torch.cuda.empty_cache()
    timed("shard_frames_cli", cs.phase_shard_frames_cli, torch, card)
    torch.cuda.empty_cache()
    _, eng = timed("svd_train", cs.phase_svd_train, torch, card)
    timed("ddp_step", cs.phase_ddp_step, torch, card, eng)
    print(f"[slice 11] phases (s) {marks}, all "
          f"{time.perf_counter() - t_all:.1f} s | {card}", flush=True)


if __name__ == "__main__":
    main()
