"""Shared CLI plumbing for the pipeline stages.

Port of the GS part of ``multiview_inpaint_tpu/pipelines/common.py``
(reference ``gs-simp/arguments/__init__.py``): the model and optimization
args, and the ``cfg_args`` JSON in the model dir that lets render-side
tools recover training settings. The JAX CLIs' ``--backend`` becomes
``--device {cuda,cpu}`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..models.gs_trainer import OptimizationConfig
from ..utils.device import DEFAULT_DEVICE, resolve_device


def add_model_args(parser: argparse.ArgumentParser):
    parser.add_argument("--source_path", "-s", type=str, default="")
    parser.add_argument("--model_path", "-m", type=str, default="")
    parser.add_argument("--images", "-i", type=str, default="images")
    parser.add_argument("--resolution", "-r", type=int, default=8)
    parser.add_argument("--white_background", "-w", action="store_true")
    parser.add_argument("--sh_degree", type=int, default=0)
    parser.add_argument("--eval", action="store_true")


def add_device_arg(parser: argparse.ArgumentParser):
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        choices=["cuda", "cpu"],
                        help="where to run: cuda (the kernels, default) "
                             "or cpu (their plain PyTorch versions)")


def add_optimization_args(parser: argparse.ArgumentParser,
                          preset: OptimizationConfig = OptimizationConfig()):
    for f in dataclasses.fields(OptimizationConfig):
        parser.add_argument(f"--{f.name}", type=type(getattr(preset, f.name)),
                            default=getattr(preset, f.name))


def optimization_config_from(args) -> OptimizationConfig:
    return OptimizationConfig(**{f.name: getattr(args, f.name)
                                 for f in dataclasses.fields(
                                     OptimizationConfig)})


def dump_cfg(model_path: str, args: argparse.Namespace):
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump({k: v for k, v in vars(args).items()
                   if isinstance(v, (int, float, str, bool, type(None)))},
                  f, indent=1)


def load_cfg(model_path: str, args: argparse.Namespace,
             cli_specified: set) -> argparse.Namespace:
    """Merge stored training cfg with CLI (CLI wins for specified flags)."""
    path = os.path.join(model_path, "cfg_args.json")
    if os.path.exists(path):
        with open(path) as f:
            stored = json.load(f)
        for k, v in stored.items():
            if hasattr(args, k) and k not in cli_specified:
                setattr(args, k, v)
    return args


def default_background(white_background: bool,
                       device=DEFAULT_DEVICE) -> torch.Tensor:
    fill = 1.0 if white_background else 0.0
    return torch.full((3,), fill, dtype=torch.float32,
                      device=resolve_device(device))
