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
  ``in_proj_weight``/``in_proj_bias`` and ``out_proj``; the text tower's
  ``token_embedding/embedding`` -> ``token_embedding.weight``.

Each component's keys carry its reference prefix (``PREFIXES``), as in
the SVD checkpoint and the ControlNet checkpoints; ``SVDEngine
.load_reference_state_dict`` reads them. The OpenCLIP text tower
(``clip_text.CLIPTextTower``) is the component ``clip_text``, under the
SD2 text conditioner's prefix (``TEXT_PREFIX``); no engine holds it. The
2D networks of SDS and ``ctrl_inpaint`` are the components ``unet2d``
(``unet2d.UNet2D``), ``controlnet2d`` (``controlnet2d.ControlNet2D``) and
``vae2d`` (``vae.AutoencoderKL(video_decoder=False)``), under the UNet's,
the ControlNet's and the VAE's prefixes; they differ from ``unet``,
``controlnet`` and ``vae`` only on the way back to JAX, where the video
networks' ResBlocks and decoder blocks gain a ``spatial`` level and the
2D ones do not. (``models/dpt.state_dict_from_jax`` carries the DPT depth
network, in the HF key space.)

``import_state_dict`` loads a torch state dict into a module, tolerantly,
and returns the missing and unexpected keys: the counterpart of the JAX
``weights_io.import_unet``/``import_vae``/``import_controlnet``.

``state_dict_to_jax`` goes the other way, with the JAX package's own key
maps (``weights_io._map_unet_key``, ``_map_vae_key``, ``_map_clip_tower``,
copied here); ``save_params``, ``load_params`` and ``merge_params`` are
the JAX ``diffusion/checkpoint.py`` on flat ``{"a/b/c": ndarray}`` dicts
(its npz layout: keys joined by "/"). bf16 leaves: numpy has no bf16, so
a leaf that the JAX package saved from bf16 reads back as raw ``'<V2'``
records; ``load_params`` takes them as bf16 bit patterns (exact in f32),
and ``save_params`` writes bf16 tensors as f32, which is exact and which
the JAX ``load_params`` reads.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

PREFIXES = {
    "unet": "model.diffusion_model.",
    "controlnet": "control_model.",
    "vae": "first_stage_model.",
    "clip": "conditioner.embedders.0.open_clip.model.visual.",
}
TEXT_PREFIX = "cond_stage_model.model."
_COMPONENTS = dict(PREFIXES, clip_text=TEXT_PREFIX)
# The 2D networks share the video networks' prefixes; ``state_dict_to_jax``
# takes them only when named.
_COMPONENTS_2D = {"unet2d": PREFIXES["unet"],
                  "controlnet2d": PREFIXES["controlnet"],
                  "vae2d": PREFIXES["vae"]}

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
        elif parts[1] == "embedding":
            sd[f"{parts[0]}.weight"] = arr
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
    state; or ``clip_text/``, ``unet2d/``, ``controlnet2d/``, ``vae2d/``)
    unless ``component`` names the one component they all belong to (a
    ControlNet checkpoint is ``component="controlnet"``)."""
    names = dict(_COMPONENTS, **_COMPONENTS_2D)
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for path, arr in flat.items():
        if component is None:
            comp, _, rest = path.partition("/")
        else:
            comp, rest = component, path
        if comp not in names:
            raise KeyError(f"{path}: unknown engine component {comp!r}")
        groups.setdefault(comp, {})[rest] = np.asarray(arr)
    out: Dict[str, torch.Tensor] = {}
    for comp, sub in groups.items():
        if comp in ("clip", "clip_text"):
            sd = _clip_state_dict(sub)
        else:
            key_of = _vae_key if comp in ("vae", "vae2d") else _unet_key
            sd = {}
            for path, arr in sub.items():
                *body, leaf = path.split("/")
                leaf, arr = _leaf(leaf, arr)
                sd[f"{key_of(body)}.{leaf}"] = arr
        for k, v in sd.items():
            out[names[comp] + k] = torch.from_numpy(
                np.ascontiguousarray(v))
    return out


def import_state_dict(module: torch.nn.Module, state_dict: Dict,
                      prefix: str = "") -> Tuple[list, list]:
    """Load the entries of ``state_dict`` under ``prefix`` (stripped) into
    ``module`` in place, tolerantly: returns (missing, unexpected), the
    module keys nothing filled and the entries with no module key of
    their shape, as the JAX ``weights_io`` importers report them. Values
    are copied into the module's own device and type."""
    own = module.state_dict()
    missing = set(own)
    unexpected = []
    with torch.no_grad():
        for k, v in state_dict.items():
            if not k.startswith(prefix):
                continue
            name = k[len(prefix):]
            if name in own and tuple(own[name].shape) == tuple(v.shape):
                own[name].copy_(torch.as_tensor(v))
                missing.discard(name)
            else:
                unexpected.append(name if name not in own else
                                  f"{name} shape {tuple(v.shape)} vs "
                                  f"{tuple(own[name].shape)}")
    return sorted(missing), unexpected


def read_state_dict(path: str, component: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
    """A weights file as a reference-keyed state dict: an npz in the JAX
    ``save_params`` layout (``component`` as in ``state_dict_from_jax``),
    a ``.safetensors`` file or a torch ``.pth``/``.ckpt`` state dict."""
    if path.endswith(".npz"):
        return state_dict_from_jax(load_params(path), component)
    if path.endswith((".safetensors", ".pth", ".ckpt")):
        return load_torch_state_dict(path)
    raise ValueError(f"{path}: expected .npz (JAX layout), .safetensors or "
                     f".pth/.ckpt")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors``, ``.pth`` or ``.ckpt`` file in the torch key
    space (its ``state_dict`` entry when it has one). A pickle that the
    weights-only load refuses (a Lightning ``.ckpt`` keeps its
    hyper-parameters as Python objects) is loaded in full, as the JAX
    ``weights_io.load_torch_state_dict`` loads every pickle: only open
    checkpoints you trust."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return load_file(path)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        print(f"{path}: the weights-only load refused it ("
              f"{str(e).splitlines()[0]}); loading it in full")
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


# --- torch key space -> JAX params (the JAX package's weights_io maps) ---

_UNET_RULES = [
    (re.compile(r"^(input_blocks|output_blocks)\.(\d+)\.(\d+)\."),
     r"\1_\2_\3."),
    (re.compile(r"^middle_block\.(\d+)\."), r"middle_block_\1."),
    (re.compile(r"^time_embed\.(\d+)\."), r"time_embed_\1."),
    (re.compile(r"^label_emb\.(\d+)\.(\d+)\."), r"label_emb_\1_\2."),
    (re.compile(r"^out\.(\d+)\."), r"out_\1."),
]


def _in_transformer(out) -> bool:
    return any(p.startswith("transformer_blocks") or
               p.startswith("time_stack_") or p == "time_stack"
               for p in out)


def _map_unet_key(key: str, video: bool = True):
    """torch UNet key (no prefix) -> flax path components; ``video=False``
    maps the 2D UNet, whose ResBlock parameters sit at block level
    instead of under ``spatial``."""
    for pat, repl in _UNET_RULES:
        key = pat.sub(repl, key)
    parts = key.split(".")
    name, leaf = parts[:-1], parts[-1]
    out = []
    i = 0
    while i < len(name):
        tok = name[i]
        if tok in ("in_layers", "emb_layers", "out_layers"):
            idx = name[i + 1]
            if video and "time_stack" not in out and \
                    not _in_transformer(out):
                if not out or out[-1] != "spatial":
                    out.append("spatial")
            out.append(f"{tok}_{idx}")
            if tok != "emb_layers" and leaf in ("weight", "bias") and \
                    idx == "0":
                out.append("norm")  # GroupNorm32 wrapper
            i += 2
            continue
        if tok == "skip_connection":
            if video and "time_stack" not in out:
                out.append("spatial")
            out.append(tok)
            i += 1
            continue
        if tok == "norm" and not _in_transformer(out) and \
                len(name) == i + 1:
            out += ["norm", "norm"]
            i += 1
            continue
        if tok == "out_0" and len(name) == i + 1:
            out += ["out_0", "norm"]
            i += 1
            continue
        if tok in ("transformer_blocks", "time_stack") and i + 1 < len(
                name) and name[i + 1].isdigit():
            out.append(f"{tok}_{name[i + 1]}")
            i += 2
            continue
        if tok in ("ff", "ff_in"):
            if name[i + 1:i + 3] == ["net", "0"]:
                out += [tok, "net_0_proj"]
                i += 4
            else:
                out += [tok, "net_2"]
                i += 3
            continue
        if tok == "to_out":
            out.append("to_out_0")
            i += 2
            continue
        if tok == "time_pos_embed":
            out.append(f"time_pos_embed_{name[i + 1]}")
            i += 2
            continue
        out.append(tok)
        i += 1
    if leaf == "mix_factor":
        return out + ["mix_factor"]
    if leaf == "weight":
        leaf = "scale" if out and "norm" in out[-1] else "kernel"
    return out + [leaf]


def _map_controlnet_key(key: str, video: bool = True):
    for head in ("input_hint_block.", "zero_convs.", "middle_block_out."):
        if key.startswith(head):
            *body, leaf = key.split(".")
            return ["_".join(body), "kernel" if leaf == "weight" else leaf]
    return ["trunk"] + _map_unet_key(key, video)


_TO_JAX_VAE_RULES = [
    (re.compile(r"down\.(\d+)\.block\.(\d+)\."), r"down_\1_block_\2."),
    (re.compile(r"down\.(\d+)\.downsample\.conv\."),
     r"down_\1_downsample_conv."),
    (re.compile(r"up\.(\d+)\.block\.(\d+)\."), r"up_\1_block_\2."),
    (re.compile(r"up\.(\d+)\.upsample\.conv\."), r"up_\1_upsample_conv."),
    (re.compile(r"mid\.block_(\d+)\."), r"mid_block_\1."),
    (re.compile(r"mid\.attn_1\."), r"mid_attn_1."),
    (re.compile(r"conv_out\.time_mix_conv\."), r"conv_out_time_mix."),
]
_TO_JAX_VAE_TIME_STACK = [
    ("time_stack.in_layers.0", "time_stack_in_norm"),
    ("time_stack.in_layers.2", "time_stack_in_conv"),
    ("time_stack.out_layers.0", "time_stack_out_norm"),
    ("time_stack.out_layers.3", "time_stack_out_conv"),
    ("time_stack.skip_connection", "time_stack_skip"),
]


def _map_vae_key(key: str, video_decoder: bool = True):
    """torch KL-VAE key -> flax path components (the video decoder's
    spatial block parameters under ``spatial``)."""
    for pat, repl in _TO_JAX_VAE_RULES:
        key = pat.sub(repl, key)
    for old, new in _TO_JAX_VAE_TIME_STACK:
        key = key.replace(old, new)
    *body, leaf = key.split(".")
    if video_decoder and body and body[0] == "decoder":
        blockish = len(body) > 1 and (
            body[1].startswith("mid_block") or "_block_" in body[1])
        if blockish and len(body) > 2 and body[2] in (
                "norm1", "conv1", "norm2", "conv2", "nin_shortcut"):
            body = body[:2] + ["spatial"] + body[2:]
    if leaf == "mix_factor":
        return body + ["mix_factor"]
    if leaf == "weight":
        leaf = "scale" if body and "norm" in body[-1] else "kernel"
    return body + [leaf]


def _jax_layout(arr: np.ndarray) -> np.ndarray:
    """torch Conv2d/Conv3d/Linear weight -> flax layout; others as they
    are."""
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 5:
        return arr.transpose(2, 3, 4, 1, 0)
    if arr.ndim == 2:
        return arr.T
    return arr


def _clip_to_jax(sd: Dict[str, np.ndarray], heads: int):
    """OpenCLIP visual or text tower (prefix stripped) -> flax leaves,
    split per head as the JAX ``CLIPVisionTower`` and ``CLIPTextTower``
    hold them."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[:2] == ["transformer", "resblocks"]:
            block = f"resblocks_{parts[2]}"
            rest, leaf = parts[3:-1], parts[-1]
            if rest and rest[0] == "attn":
                w = v.shape[-1]
                if leaf == "in_proj_weight":
                    for name, chunk in zip(("query", "key", "value"),
                                           np.split(v, 3, axis=0)):
                        out[f"{block}/attn/{name}/kernel"] = \
                            chunk.T.reshape(w, heads, w // heads)
                elif leaf == "in_proj_bias":
                    for name, chunk in zip(("query", "key", "value"),
                                           np.split(v, 3, axis=0)):
                        out[f"{block}/attn/{name}/bias"] = chunk.reshape(
                            heads, -1)
                elif leaf == "weight":
                    out[f"{block}/attn/out/kernel"] = v.T.reshape(
                        heads, w // heads, w)
                else:
                    out[f"{block}/attn/out/bias"] = v
            elif rest[0] in ("ln_1", "ln_2"):
                out[f"{block}/{rest[0]}/"
                    f"{'scale' if leaf == 'weight' else 'bias'}"] = v
            else:
                out[f"{block}/mlp_{rest[1]}/"
                    f"{'kernel' if leaf == 'weight' else 'bias'}"] = (
                    v.T if leaf == "weight" else v)
        elif k in ("class_embedding", "positional_embedding", "proj",
                   "text_projection"):
            out[k] = v
        elif k == "token_embedding.weight":
            out["token_embedding/embedding"] = v
        elif k == "conv1.weight":
            out["conv1/kernel"] = v.transpose(2, 3, 1, 0)
        elif parts[0] in ("ln_pre", "ln_post", "ln_final"):
            out[f"{parts[0]}/{'scale' if parts[-1] == 'weight' else 'bias'}"
                ] = v
    return out


def _numpy(t) -> np.ndarray:
    """A tensor (copied) or an array as numpy, bf16 as (exact) f32."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", torch.float32 if t.dtype == torch.bfloat16
                          else t.dtype, copy=True)
        return t.numpy()
    return np.asarray(t)


def state_dict_to_jax(sd: Dict[str, torch.Tensor],
                      component: Optional[str] = None,
                      clip_heads: int = 16) -> Dict[str, np.ndarray]:
    """Reference torch state dict (prefixed keys) -> the JAX package's
    flat params, the inverse of ``state_dict_from_jax``: keys
    ``"<component>/a/b/c"``, or ``"a/b/c"`` when ``component`` names the
    one component to take (the layout of a ControlNet checkpoint). bf16
    tensors come out as f32 (exact). ``clip_heads`` is the head count of
    the CLIP tower at hand (the text tower's with ``clip_text``). The 2D
    components (``unet2d``, ``controlnet2d``, ``vae2d``) are taken only
    when ``component`` names one."""
    out: Dict[str, np.ndarray] = {}
    comps = (_COMPONENTS if component is None else
             {component: dict(_COMPONENTS, **_COMPONENTS_2D)[component]})
    for comp, prefix in comps.items():
        sub = {k[len(prefix):]: _numpy(v) for k, v in sd.items()
               if k.startswith(prefix)}
        if comp in ("clip", "clip_text"):
            flat = _clip_to_jax(sub, clip_heads)
        else:
            key_map = {
                "unet": _map_unet_key, "vae": _map_vae_key,
                "controlnet": _map_controlnet_key,
                "unet2d": lambda k: _map_unet_key(k, video=False),
                "vae2d": lambda k: _map_vae_key(k, video_decoder=False),
                "controlnet2d": lambda k: _map_controlnet_key(
                    k, video=False)}[comp]
            flat = {"/".join(key_map(k)): _jax_layout(v)
                    for k, v in sub.items()}
        lead = "" if component is not None else comp + "/"
        out.update({lead + k: np.ascontiguousarray(v)
                    for k, v in flat.items()})
    return out


# --- npz parameter files (the JAX diffusion/checkpoint.py) --------------

def _flatten(tree, prefix="") -> Dict:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = v
    return flat


def save_params(path: str, params: Dict) -> None:
    """Write params, flat ``{"a/b": array}`` or nested dicts, in the JAX
    ``save_params`` layout, bf16 tensors as f32 (exact). Uncompressed
    ``np.savez``, where the JAX function compresses: compressing the
    0.68B-parameter ControlNet took minutes against a train step's
    second; the JAX ``load_params`` reads both."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _numpy(v) for k, v in _flatten(params).items()}
    np.savez(path, **flat)


def _from_raw_bf16(arr: np.ndarray) -> np.ndarray:
    """A ``'<V2'`` leaf (numpy's record of a bf16 array) as exact f32."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    return arr


def load_params(path: str) -> Dict[str, np.ndarray]:
    """A flat ``{"a/b/c": ndarray}`` params file (the JAX ``load_params``
    without the unflattening), bf16 leaves as f32."""
    with np.load(path) as z:
        return {k: _from_raw_bf16(z[k]) for k in z.files}


def merge_params(base: Dict[str, np.ndarray], loaded: Dict[str, np.ndarray]
                 ) -> Tuple[Dict[str, np.ndarray], list, list]:
    """Tolerant overlay of ``loaded`` onto ``base`` (flat dicts, shapes
    checked): returns (merged, missing keys, unexpected keys)."""
    merged = dict(base)
    unexpected = []
    for k, v in loaded.items():
        if k in base and tuple(np.shape(base[k])) == tuple(np.shape(v)):
            merged[k] = v
        else:
            unexpected.append(k)
    missing = [k for k in base if k not in loaded]
    return merged, missing, unexpected
