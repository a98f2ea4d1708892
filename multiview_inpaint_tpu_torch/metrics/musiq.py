"""MUSIQ, the multi-scale image quality transformer — counterpart of
``multiview_inpaint_tpu/metrics/musiq.py`` (Ke et al., ICCV 2021; the
reference scores renders with pyiqa's ``musiq``).

- Multi-scale input: the native-resolution image plus aspect-ratio-
  preserving resizes whose longer side is 384 and 224, through
  ``clip_vit.resize_bilinear`` (``jax.image.resize``'s bilinear weights,
  antialiased when shrinking; ``F.interpolate`` differs from it);
- each scale padded bottom/right to a multiple of 32 and cut into 32x32
  patches, each flattened as [p, p, 3] in NHWC order (the rows of the
  patch projection follow that order), all scales sharing ONE linear
  patch projection;
- the hash spatial embedding (a ``grid x grid`` table indexed by each
  patch's normalised grid cell), a learned per-scale embedding, a CLS
  token, pre-LN blocks (LayerNorm eps 1e-6, flax's default; the exact
  GELU), a final LayerNorm and a linear head.

The attention is plain matmul + softmax in f32, as the port's other
networks whose JAX attention calls no kernel: at 1080p MUSIQ runs 2,153
tokens (not a multiple of the flash kernel's block).

Module names are the torch MUSIQ key space that the JAX ``import_musiq``
reads (``embedding.patch_projection``, ``cls_token``, ``norm``, ``head``,
``blocks.{i}.norm1``, ``blocks.{i}.attn.in_proj_weight``,
``blocks.{i}.mlp.fc1`` ...), so ``import_musiq`` loads such a state dict
directly; ``state_dict_from_jax``/``state_dict_to_jax`` carry JAX params
through the port's OpenCLIP block mapping (``checkpoint._clip_state_dict``
and ``_clip_to_jax``), as the JAX importer reuses its CLIP tower map.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion import checkpoint
from ..diffusion.clip_vit import resize_bilinear
from ..utils.device import DEFAULT_DEVICE, resolve_device

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MUSIQConfig:
    patch: int = 32
    dim: int = 384
    layers: int = 14
    heads: int = 6
    mlp_dim: int = 1152
    grid: int = 10                 # hash-embedding grid (per axis)
    scales: Tuple[int, ...] = (384, 224)   # longer-side ARP resizes


TINY_MUSIQ = MUSIQConfig(patch=32, dim=32, layers=2, heads=2, mlp_dim=64,
                         grid=4, scales=(64,))


def _arp_size(h: int, w: int, longer: int) -> Tuple[int, int]:
    """Aspect-ratio-preserving size with the longer side == ``longer``."""
    if h >= w:
        return longer, max(1, round(w * longer / h))
    return max(1, round(h * longer / w)), longer


def _grid_index(gh: int, gw: int, grid: int) -> np.ndarray:
    """[gh*gw] flat indices into the grid x grid hash table."""
    i = np.minimum((np.arange(gh) * grid) // max(gh, 1), grid - 1)
    j = np.minimum((np.arange(gw) * grid) // max(gw, 1), grid - 1)
    return (i[:, None] * grid + j[None, :]).reshape(-1)


class _Attention(nn.Module):
    """Multi-head self-attention with packed q/k/v projections (the
    ``nn.MultiheadAttention`` layout), plain f32 matmul + softmax."""

    def __init__(self, dim: int, heads: int, **factory):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim,
                                                       **factory))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, **factory))
        self.out_proj = nn.Linear(dim, dim, **factory)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        b, t, dim = x.shape
        d = dim // self.heads
        q, k, v = (y.reshape(b, t, self.heads, d).transpose(1, 2)
                   for y in F.linear(x, self.in_proj_weight,
                                     self.in_proj_bias).chunk(3, dim=-1))
        # flax scales the query before the product
        logits = torch.matmul(q * d ** -0.5, k.transpose(-1, -2))
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, dim))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, **factory):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, **factory)
        self.fc2 = nn.Linear(hidden, dim, **factory)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, cfg: MUSIQConfig, **factory):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.dim, eps=LN_EPS, **factory)
        self.attn = _Attention(cfg.dim, cfg.heads, **factory)
        self.norm2 = nn.LayerNorm(cfg.dim, eps=LN_EPS, **factory)
        self.mlp = _Mlp(cfg.dim, cfg.mlp_dim, **factory)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _Embedding(nn.Module):
    def __init__(self, cfg: MUSIQConfig, **factory):
        super().__init__()
        self.patch_projection = nn.Linear(cfg.patch * cfg.patch * 3, cfg.dim,
                                          **factory)
        self.spatial_embedding = nn.Parameter(0.02 * torch.randn(
            cfg.grid * cfg.grid, cfg.dim, **factory))
        self.scale_embedding = nn.Parameter(0.02 * torch.randn(
            len(cfg.scales) + 1, cfg.dim, **factory))


class MUSIQ(nn.Module):
    def __init__(self, cfg: MUSIQConfig = MUSIQConfig(), **factory):
        super().__init__()
        self.cfg = cfg
        self.embedding = _Embedding(cfg, **factory)
        self.cls_token = nn.Parameter(0.02 * torch.randn(1, 1, cfg.dim,
                                                         **factory))
        self.blocks = nn.ModuleList(_Block(cfg, **factory)
                                    for _ in range(cfg.layers))
        self.norm = nn.LayerNorm(cfg.dim, eps=LN_EPS, **factory)
        self.head = nn.Linear(cfg.dim, 1, **factory)

    def tokenize(self, x, scale_idx: int):
        """[B, h, w, 3] -> [B, patches, dim] tokens of one scale."""
        cfg, p = self.cfg, self.cfg.patch
        b, sh, sw, _ = x.shape
        ph, pw = -sh % p, -sw % p
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        gh, gw = (sh + ph) // p, (sw + pw) // p
        x = x.reshape(b, gh, p, gw, p, 3).transpose(2, 3).reshape(
            b, gh * gw, p * p * 3)
        tok = self.embedding.patch_projection(x)
        idx = torch.as_tensor(_grid_index(gh, gw, cfg.grid), device=x.device)
        tok = tok + self.embedding.spatial_embedding[idx]
        return tok + self.embedding.scale_embedding[scale_idx]

    def tokens(self, img) -> int:
        """The token count of an image of ``img``'s shape (CLS included)."""
        h, w = img.shape[1:3]
        p = self.cfg.patch
        sizes = [(h, w)] + [_arp_size(h, w, s) for s in self.cfg.scales]
        return 1 + sum(-(-a // p) * -(-b // p) for a, b in sizes)

    def forward(self, img):
        """img [B, H, W, 3] in [0, 1] -> scores [B]."""
        b, h, w, _ = img.shape
        tokens = [self.tokenize(img, 0)]
        for s, longer in enumerate(self.cfg.scales):
            x = resize_bilinear(img, _arp_size(h, w, longer))
            tokens.append(self.tokenize(x, s + 1))
        x = torch.cat([self.cls_token.expand(b, -1, -1)] + tokens, dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.norm(x[:, 0]))[:, 0]


class MUSIQScorer:
    """numpy [H, W, 3] in [0, 1] -> float, on ``device``; ``params`` are
    JAX params (a nested tree or flat ``{"a/b": ndarray}``, as
    ``checkpoint.load_params`` reads the JAX npz); ``device`` defaults to
    the card and raises without one."""

    def __init__(self, params: Dict, cfg: MUSIQConfig = MUSIQConfig(),
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.model = MUSIQ(cfg, device=self.device)
        self.model.load_state_dict(state_dict_from_jax(
            checkpoint.flatten_tree(params)))
        self.model.requires_grad_(False).eval()

    def __call__(self, img: np.ndarray) -> float:
        x = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        with torch.no_grad():
            return float(self.model(x[None])[0])


# Default torch-key mapping (one common torch port's naming; ours ->
# theirs); the key space of torch MUSIQ ports is not standardised, so
# ``import_musiq`` takes an override table.
_TORCH_MAP = {
    "patch_proj": "embedding.patch_projection",
    "spatial_embedding": "embedding.spatial_embedding",
    "scale_embedding": "embedding.scale_embedding",
    "cls": "cls_token",
    "ln_final": "norm",
    "head": "head",
}
# block sub-keys: the OpenCLIP names the JAX importer renames to -> ours
_BLOCK_SUBS = (("ln_1", "norm1"), ("ln_2", "norm2"), ("mlp.c_fc", "mlp.fc1"),
               ("mlp.c_proj", "mlp.fc2"))


def _block_key(i: str, sub: str) -> str:
    for clip, ours in _BLOCK_SUBS:
        sub = sub.replace(clip, ours)
    return f"blocks.{i}.{sub}"


def state_dict_from_jax(flat: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """JAX MUSIQ params (flat) -> a ``MUSIQ`` state dict: the blocks as
    OpenCLIP resblocks through ``checkpoint._clip_state_dict`` (per-head
    q/k/v kernels [D, heads, d] packed into ``in_proj_weight``, the out
    kernel [heads, d, D] reshaped), the rest by ``_TORCH_MAP``."""
    clip = {}
    for path, arr in flat.items():
        parts = path.split("/")
        if parts[0].startswith("block_"):
            parts[0] = "resblocks_" + parts[0].split("_")[1]
            parts[1] = {"mlp_0": "mlp_c_fc", "mlp_1": "mlp_c_proj"}.get(
                parts[1], parts[1])
        clip["/".join(parts)] = np.asarray(arr, np.float32)
    out = {}
    for k, v in checkpoint._clip_state_dict(clip).items():
        parts = k.split(".")
        if parts[:2] == ["transformer", "resblocks"]:
            k = _block_key(parts[2], ".".join(parts[3:]))
        else:
            k = ".".join([_TORCH_MAP[parts[0]]] + parts[1:])
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def state_dict_to_jax(sd: Dict[str, torch.Tensor], heads: int
                      ) -> Dict[str, np.ndarray]:
    """A ``MUSIQ`` state dict -> JAX MUSIQ params (flat), the inverse of
    ``state_dict_from_jax`` (blocks through ``checkpoint._clip_to_jax``)."""
    inv = {v: k for k, v in _TORCH_MAP.items()}
    clip, out = {}, {}
    for k, v in sd.items():
        arr = checkpoint._numpy(v)
        parts = k.split(".")
        if parts[0] == "blocks":
            sub = ".".join(parts[2:])
            for theirs, ours in _BLOCK_SUBS:
                sub = sub.replace(ours, theirs)
            clip[f"transformer.resblocks.{parts[1]}.{sub}"] = arr
            continue
        stem, leaf = ".".join(parts[:-1]), parts[-1]
        if k in inv:
            out[inv[k]] = arr
        elif leaf == "weight" and inv[stem] == "ln_final":
            out[f"{inv[stem]}/scale"] = arr
        elif leaf == "weight":
            out[f"{inv[stem]}/kernel"] = arr.T
        else:
            out[f"{inv[stem]}/{leaf}"] = arr
    for k, v in checkpoint._clip_to_jax(clip, heads).items():
        parts = k.split("/")
        parts[0] = "block_" + parts[0].split("_")[1]
        parts[1] = {"mlp_c_fc": "mlp_0", "mlp_c_proj": "mlp_1"}.get(
            parts[1], parts[1])
        out["/".join(parts)] = v
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def import_musiq(model: MUSIQ, state_dict: Dict,
                 key_map: Optional[Dict[str, str]] = None):
    """Load a torch MUSIQ state dict into ``model`` (tolerantly, as the
    JAX ``import_musiq`` merges); returns (missing, unexpected).

    Blocks may sit under ``transformer``, ``blocks`` or ``encoder`` (with
    ``norm1``/``ln_1``, ``mlp.fc1``/``mlp.c_fc`` ...); top-level names go
    through ``key_map`` (ours -> theirs; defaults above)."""
    km = dict(_TORCH_MAP)
    km.update(key_map or {})
    inv = {v: _TORCH_MAP[k] for k, v in km.items()}
    renamed = {}
    for k, v in state_dict.items():
        parts = k.split(".")
        if parts[0] in ("transformer", "blocks", "encoder"):
            i = parts[1] if parts[1].isdigit() else parts[2]
            rest = parts[2 if parts[1].isdigit() else 3:]
            renamed[_block_key(i, ".".join(rest))] = v
            continue
        stem = ".".join(parts[:-1])
        if stem in inv:
            renamed[f"{inv[stem]}.{parts[-1]}"] = v
        elif k in inv:
            renamed[inv[k]] = v
        else:
            renamed[k] = v
    return checkpoint.import_state_dict(model, renamed)
