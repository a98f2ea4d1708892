"""Diffusion weights: the JAX carrier and checkpoint loading.

``state_dict_from_jax`` turns the JAX package's parameters, flat
``{"a/b/c": ndarray}`` as its ``diffusion/checkpoint.save_params`` writes
them, into a state dict in the reference's torch key space, the inverse of
the JAX package's ``weights_io`` key maps:

- Conv (H, W, I, O) -> (O, I, H, W); Conv3d (T, H, W, I, O) -> (O, I, T,
  H, W); Dense (I, O) -> (O, I); ``scale`` -> ``weight``;
- flax block names -> dotted torch paths (``input_blocks_1_0`` ->
  ``input_blocks.1.0``, ``ff/net_0_proj`` -> ``ff.net.0.proj``); the
  VideoResBlock's ``spatial`` level, the GroupNorm32 wrapper's inner
  ``norm`` and the ControlNet's ``trunk`` level go;
- the VAE's ``down_N_block_M``, ``mid_block_N``, ``time_stack_in_norm``
  ... -> ``down.N.block.M``, ``mid.block_N``, ``time_stack.in_layers.0``;
- CLIP's per-head query/key/value/out kernels -> OpenCLIP's packed
  ``in_proj_weight``/``in_proj_bias`` and ``out_proj``.

Each component's keys carry its reference prefix (``PREFIXES``), as in
the SVD checkpoint and the ControlNet checkpoints; ``SVDEngine
.load_reference_state_dict`` reads them.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

PREFIXES = {
    "unet": "model.diffusion_model.",
    "controlnet": "control_model.",
    "vae": "first_stage_model.",
    "clip": "conditioner.embedders.0.open_clip.model.visual.",
}

_VAE_RULES = [
    (re.compile(r"^down_(\d+)_block_(\d+)$"), r"down.\1.block.\2"),
    (re.compile(r"^down_(\d+)_downsample_conv$"), r"down.\1.downsample.conv"),
    (re.compile(r"^up_(\d+)_block_(\d+)$"), r"up.\1.block.\2"),
    (re.compile(r"^up_(\d+)_upsample_conv$"), r"up.\1.upsample.conv"),
    (re.compile(r"^mid_block_(\d+)$"), r"mid.block_\1"),
    (re.compile(r"^mid_attn_1$"), "mid.attn_1"),
    (re.compile(r"^conv_out_time_mix$"), "conv_out.time_mix_conv"),
    (re.compile(r"^time_stack_in_norm$"), "time_stack.in_layers.0"),
    (re.compile(r"^time_stack_in_conv$"), "time_stack.in_layers.2"),
    (re.compile(r"^time_stack_out_norm$"), "time_stack.out_layers.0"),
    (re.compile(r"^time_stack_out_conv$"), "time_stack.out_layers.3"),
]


def _dotted(comp: str) -> str:
    """``input_blocks_1_0`` -> ``input_blocks.1.0``; ``net_0_proj`` ->
    ``net.0.proj``; ``skip_connection`` stays."""
    toks = comp.split("_")
    out = toks[0]
    for prev, tok in zip(toks, toks[1:]):
        out += ("." if tok.isdigit() or prev.isdigit() else "_") + tok
    return out


def _leaf(leaf: str, arr: np.ndarray):
    """flax leaf -> (torch leaf, array in torch layout)."""
    if leaf == "kernel":
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif arr.ndim == 2:
            arr = arr.T
        return "weight", arr
    return ("weight" if leaf == "scale" else leaf), arr


def _unet_key(body) -> str:
    body = [c for c in body if c not in ("spatial", "trunk")]
    if len(body) > 1 and body[-1] == "norm":   # GroupNorm32's inner norm
        body = body[:-1]
    return ".".join(_dotted(c) for c in body)


def _vae_key(body) -> str:
    out = []
    for c in body:
        if c == "spatial":
            continue
        for pat, repl in _VAE_RULES:
            if pat.match(c):
                c = pat.sub(repl, c)
                break
        out.append(c)
    return ".".join(out)


def _clip_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    sd, packed = {}, {}
    for path, arr in flat.items():
        parts = path.split("/")
        if parts[0].startswith("resblocks_"):
            pre = f"transformer.resblocks.{parts[0].split('_')[1]}."
            if parts[1] == "attn":
                proj, leaf = parts[2], parts[3]
                w = arr.shape[-1] if proj == "out" else arr.shape[0]
                if proj == "out" and leaf == "kernel":
                    sd[pre + "attn.out_proj.weight"] = arr.reshape(w, w).T
                elif proj == "out":
                    sd[pre + "attn.out_proj.bias"] = arr
                elif leaf == "kernel":
                    packed[(pre, "w", proj)] = arr.reshape(w, -1).T
                else:
                    packed[(pre, "b", proj)] = arr.reshape(-1)
                continue
            name, leaf = parts[1], parts[2]
            name = name.replace("mlp_", "mlp.")
            leaf, arr = _leaf(leaf, arr)
            sd[pre + f"{name}.{leaf}"] = arr
        elif len(parts) == 1:
            sd[parts[0]] = arr
        else:
            leaf, arr = _leaf(parts[1], arr)
            sd[f"{parts[0]}.{leaf}"] = arr
    for pre in sorted({k[0] for k in packed}):
        sd[pre + "attn.in_proj_weight"] = np.concatenate(
            [packed[(pre, "w", p)] for p in ("query", "key", "value")])
        sd[pre + "attn.in_proj_bias"] = np.concatenate(
            [packed[(pre, "b", p)] for p in ("query", "key", "value")])
    return sd


def state_dict_from_jax(flat: Dict[str, np.ndarray],
                        component: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX parameters -> reference torch state dict (prefixed keys).

    ``flat`` keys start with the engine component (``unet/``,
    ``controlnet/``, ``vae/``, ``clip/``: the layout of a saved engine
    state) unless ``component`` names the one component they all belong
    to (a ControlNet checkpoint is ``component="controlnet"``)."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for path, arr in flat.items():
        if component is None:
            comp, _, rest = path.partition("/")
        else:
            comp, rest = component, path
        if comp not in PREFIXES:
            raise KeyError(f"{path}: unknown engine component {comp!r}")
        groups.setdefault(comp, {})[rest] = np.asarray(arr)
    out: Dict[str, torch.Tensor] = {}
    for comp, sub in groups.items():
        if comp == "clip":
            sd = _clip_state_dict(sub)
        else:
            key_of = _vae_key if comp == "vae" else _unet_key
            sd = {}
            for path, arr in sub.items():
                *body, leaf = path.split("/")
                leaf, arr = _leaf(leaf, arr)
                sd[f"{key_of(body)}.{leaf}"] = arr
        for k, v in sd.items():
            out[PREFIXES[comp] + k] = torch.from_numpy(
                np.ascontiguousarray(v))
    return out


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """A flattened-npz parameter file (the JAX ``save_params`` layout)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth``/``.ckpt`` file in the torch key space (its
    ``state_dict`` entry when it has one)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return sd
