"""Tiny sizes of the SDS cell for the CPU tests, laid over the scratch
copy of the benchmark that ``tiny.tiny_bench`` makes."""

from __future__ import annotations

import json
import os

from port_bench.tests.tiny import _merge

TINY_SD2 = {
    "unet": {"model_channels": 32, "num_res_blocks": 1,
             "attention_resolutions": [1], "channel_mult": [1, 2],
             "num_head_channels": 16, "context_dim": 16},
    "vae": {"ch": 16, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 1},
    "text_tokens": 5, "sds_size": 32, "num_gaussians": 3000,
    "box": {"n_samples": 200},
}
TINY_SDS_TRAFFIC = {"width": 64, "height": 48, "views": 4,
                    "traced_steps": 2, "captured_frames": 1}


def shrink(bench: str) -> None:
    """Lay the tiny sizes over the SDS cell's files under ``bench``."""
    for sub, name, over in (("configs", "sd2-inpaint-sds", TINY_SD2),
                            ("traffic", "sds-orbit-1080p",
                             TINY_SDS_TRAFFIC)):
        path = os.path.join(bench, sub, name + ".json")
        with open(path) as f:
            data = _merge(json.load(f), over)
        with open(path, "w") as f:
            json.dump(data, f)
