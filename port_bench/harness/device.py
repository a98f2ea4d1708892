"""The card a run measures: presence, name, power limit, memory peak."""

from __future__ import annotations

import subprocess
import sys


def require(torch, chips: int) -> None:
    """Exit with code 2 unless ``chips`` CUDA devices are there; a run
    never falls back to the CPU."""
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device, no result", file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"port_bench: {torch.cuda.device_count()} CUDA devices, the "
              f"cell needs {chips}; no result", file=sys.stderr)
        raise SystemExit(2)


def power_limit() -> str | None:
    """The card's ``power.limit`` as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].split(",")[-1].strip() if lines else None


def describe(torch, chips: int) -> dict:
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}
