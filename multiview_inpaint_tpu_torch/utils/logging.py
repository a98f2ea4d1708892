"""Minimal structured training logger: JSONL metrics + stdout.

Port of ``multiview_inpaint_tpu/utils/logging.py`` (it replaces the
reference's TensorBoard writers, ``gs-simp/train.py:134-196``) with its
JSONL stream only: one ``<name>_log.jsonl`` per run, easily plotted or
tailed. The JAX logger's optional wandb mirror is not ported.
"""

from __future__ import annotations

import json
import os
import sys
import time


class RunLogger:
    def __init__(self, model_path: str, name: str = "train"):
        os.makedirs(model_path, exist_ok=True)
        self.path = os.path.join(model_path, f"{name}_log.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def echo(self, msg: str):
        print(msg, file=sys.stdout, flush=True)

    def close(self):
        self._f.close()
