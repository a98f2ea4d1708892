"""Minimal structured training logger: JSONL metrics + stdout.

Port of ``multiview_inpaint_tpu/utils/logging.py`` (a copy: the JAX
module imports no JAX). It replaces the reference's TensorBoard writers
(``gs-simp/train.py:134-196``) with a dependency-free JSONL stream per
run (easily plotted or tailed). The reference's optional wandb logger
(``svd_inpaint1/main.py:676-700`` builds a WandbLogger when ``--wandb``
is passed) maps to ``backend="wandb"``: if the ``wandb`` package can be
imported it mirrors every ``log()`` row to a wandb run; otherwise it
warns once and keeps the JSONL stream alone.
"""

from __future__ import annotations

import json
import os
import sys
import time


class RunLogger:
    def __init__(self, model_path: str, name: str = "train",
                 backend: str = "jsonl", wandb_project: str | None = None,
                 config: dict | None = None):
        os.makedirs(model_path, exist_ok=True)
        self.path = os.path.join(model_path, f"{name}_log.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()
        self._wandb = None
        if backend == "wandb":
            # Any failure to start a run (the package missing, no network,
            # no login) leaves the JSONL stream on its own.
            try:
                import wandb
                self._wandb = wandb.init(
                    project=wandb_project or "multiview_inpaint_tpu",
                    name=f"{name}_{os.path.basename(model_path)}",
                    dir=model_path, config=config or {})
            except Exception as e:  # noqa: BLE001
                self.echo(f"wandb unavailable ({e!r}); falling back to "
                          f"JSONL at {self.path}")
        elif backend != "jsonl":
            raise ValueError(f"unknown logger backend {backend!r}")

    def log(self, step: int, **metrics):
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            row = {k: v for k, v in rec.items() if k != "step"}
            # step<0 marks out-of-band events (e.g. final_ema_eval).
            self._wandb.log(row, step=step if step >= 0 else None)

    def echo(self, msg: str):
        print(msg, file=sys.stdout, flush=True)

    def close(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
