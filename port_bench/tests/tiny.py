"""Tiny sizes of the benchmark's configurations and traffic for the CPU
tests, and a scratch copy of the benchmark that holds them."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# The tiny engine computes in float32, so that the program agrees with
# the reference to rounding and every planted fault stands out.
TINY_SVD = {
    "num_frames": 3, "resolution": [64, 48],
    "param_dtype": "float32", "compute_dtype": "float32",
    "unet": {"model_channels": 32, "num_res_blocks": 1,
             "attention_resolutions": [1], "channel_mult": [1, 2],
             "num_head_channels": 16, "context_dim": 16},
    "vae": {"ch": 16, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 1},
    "vit": {"image_size": 224, "patch_size": 32, "width": 64, "layers": 2,
            "heads": 2, "output_dim": 16},
}
TINY_GS = {"num_gaussians": 3000}
TINY_TRAFFIC = {
    "clip-stream": {"num_steps": 2, "warm_steps": 1},
    "orbit-train-1080p": {"width": 64, "height": 48, "views": 4,
                          "traced_steps": 2, "captured_frames": 2},
    "orbit-render-1080p": {"width": 64, "height": 48, "views": 4,
                           "traced_frames": 4, "captured_frames": 2,
                           "checked_frames": 2, "checked_among": 4},
}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) else v
    return out


def tiny_bench(tmp: str) -> tuple:
    """A copy of the benchmark's folder under ``tmp`` with tiny
    configurations and traffic; returns (manifest path, bench folder)."""
    bench = os.path.join(tmp, "port_bench")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for name, over in (("svd-xt-ctrlnet", TINY_SVD),
                       ("gs-mip360-2m", TINY_GS)):
        path = os.path.join(bench, "configs", name + ".json")
        with open(path) as f:
            cfg = _merge(json.load(f), over)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name, over in TINY_TRAFFIC.items():
        path = os.path.join(bench, "traffic", name + ".json")
        with open(path) as f:
            tr = _merge(json.load(f), over)
        with open(path, "w") as f:
            json.dump(tr, f)
    manifest = os.path.join(tmp, "BENCHMARK.json")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), manifest)
    return manifest, bench
