"""Profile the port's ``train_gs`` CLI on the GPU and summarise the trace.

    python scripts/port_profile_train.py

Runs ``chip_smoke.py``'s main path 2 (``chip_smoke.phase_train``: the
orbit scene, its first step's K3 check, the train CLI with its checks)
for 110 iterations with ``--profile_dir build/profile_train`` (a
``torch.profiler`` trace of iterations 100-109), then reads that chrome
trace and prints one JSON line: the window from the first to the last
device event, the device's busy and idle share over it, and device time
by kernel name. Imports the port only (no JAX).
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def summarise(trace_path: str, top: int = 12) -> dict:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        raise SystemExit(f"no device events in {trace_path}: the profiler "
                         f"did not trace the card")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    window = spans[-1][1] - spans[0][0]
    by_name = collections.Counter()
    count = collections.Counter()
    for e in dev:
        by_name[e["name"]] += e["dur"]
        count[e["name"]] += 1
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window, "device_events": len(dev),
            "top_ms": [{"name": n[:80], "ms": t / 1e3, "count": count[n]}
                       for n, t in by_name.most_common(top)]}


def main():
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    prof = os.path.join(REPO, "build", "profile_train")
    shutil.rmtree(prof, ignore_errors=True)
    card = chip_smoke.phase_card(torch)
    chip_smoke.phase_train(torch, card, iterations=110,
                           extra=("--profile_dir", prof))
    print(json.dumps(summarise(os.path.join(prof, "trace.json"))))


if __name__ == "__main__":
    main()
