"""Shared CLI plumbing for the pipeline stages.

Port of ``multiview_inpaint_tpu/pipelines/common.py`` (reference
``gs-simp/arguments/__init__.py``): the model and optimization args, the
``cfg_args`` JSON in the model dir that lets render-side tools recover
training settings, and the scene registry / orbit arguments of the
stage-1 tools. The JAX CLIs' ``--backend`` becomes ``--device
{cuda,cpu}`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..models.gs_trainer import OptimizationConfig
from ..utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class ModelArgs:
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = 8
    white_background: bool = False
    sh_degree: int = 0
    eval: bool = False


def add_registry_arg(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--registry", type=str, default=None,
        help="JSON with front_views/insertion_prompts/orbit_params "
             "overrides for scenes not in the built-in registry")


def apply_registry(args):
    if getattr(args, "registry", None):
        from ..config.registries import load_registry_overrides
        load_registry_overrides(args.registry)


def add_orbit_args(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--allow_default_orbit", action="store_true",
        help="use default OrbitParams (with a warning) when the scene is "
             "not in the orbit registry, instead of erroring")


def resolve_orbit(args, table=None):
    """Orbit geometry for args.scene_id (reference helpers.py raises on
    unknown scenes; see registries.get_orbit_params)."""
    from ..config.registries import get_orbit_params
    return get_orbit_params(
        args.scene_id.split("_")[0], table,
        allow_default=getattr(args, "allow_default_orbit", False))


def add_model_args(parser: argparse.ArgumentParser):
    parser.add_argument("--source_path", "-s", type=str, default="")
    parser.add_argument("--model_path", "-m", type=str, default="")
    parser.add_argument("--images", "-i", type=str, default="images")
    parser.add_argument("--resolution", "-r", type=int, default=8)
    parser.add_argument("--white_background", "-w", action="store_true")
    parser.add_argument("--sh_degree", type=int, default=0)
    parser.add_argument("--eval", action="store_true")


def model_args_from(args) -> ModelArgs:
    return ModelArgs(source_path=os.path.abspath(args.source_path),
                     model_path=args.model_path, images=args.images,
                     resolution=args.resolution,
                     white_background=args.white_background,
                     sh_degree=args.sh_degree, eval=args.eval)


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
