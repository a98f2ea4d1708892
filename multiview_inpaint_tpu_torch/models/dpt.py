"""DPT monocular depth estimator (PyTorch), for ``gen_depth --dpt_ckpt``.

Counterpart of ``multiview_inpaint_tpu/models/dpt.py``: the reference's
``gen_depth.py`` runs HuggingFace's depth-estimation pipeline
(Intel/dpt-large: a ViT-L/16 backbone with the DPT reassemble and fusion
neck) over the coarse model's orbit renders. ``DPTDepth`` is that graph
(readout "project", no hybrid backbone, no extra projection): a pre-LN
ViT (LayerNorm eps 1e-12, exact GELU, plain matmul attention: 577 tokens
at 384x384 is no flash-attention shape), the reassemble stage (readout
projection, 1x1 conv, a transposed conv up or a stride-2 conv down), the
fusion stage (pre-activation residual layers, an align-corners x2
bilinear upsample, a 1x1 projection) and the head.

Parameter names are the HF ``DPTForDepthEstimation`` keys
(``dpt.embeddings.*``, ``dpt.encoder.layer.N.*``,
``neck.reassemble_stage.*``, ``neck.convs.N``, ``neck.fusion_stage.*``,
``head.head.N``), so ``import_dpt`` is a checked load of such a state
dict: fusion layer 0's ``residual_layer1`` (never run) and
``dpt.layernorm`` (the pooled path) are consumed and dropped, as the JAX
importer does. ``state_dict_from_jax`` carries the JAX module's params
over. Inputs and outputs are NHWC / [B, H, W], as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion.clip_vit import _resize, _triangle, resize_bicubic
from ..utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    """Mirrors transformers' DPTConfig (non-hybrid subset)."""
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    patch_size: int = 16
    image_size: int = 384           # the position embedding's native grid
    out_indices: Tuple[int, ...] = (5, 11, 17, 23)
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 1024)
    reassemble_factors: Tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)
    fusion_hidden_size: int = 256
    layer_norm_eps: float = 1e-12


def _resize_align_corners(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear [B, C, H, W] resize with ``align_corners=True``: output
    sample i maps to input coordinate i (in - 1) / (out - 1); the JAX
    package's gather-and-lerp, term for term."""
    h, w = x.shape[2:]
    if (h, w) == (oh, ow):
        return x

    def axis_weights(n_in, n_out):
        if n_out == 1 or n_in == 1:
            lo = torch.zeros(n_out, dtype=torch.long, device=x.device)
            return lo, lo, torch.zeros(n_out, dtype=x.dtype, device=x.device)
        pos = (torch.arange(n_out, dtype=torch.float32, device=x.device)
               * (n_in - 1) / (n_out - 1))
        lo = torch.clamp(torch.floor(pos).long(), 0, n_in - 2)
        return lo, lo + 1, (pos - lo).to(x.dtype)

    ylo, yhi, wy = axis_weights(h, oh)
    top, bot = x[:, :, ylo], x[:, :, yhi]
    x = top + wy[None, None, :, None] * (bot - top)
    xlo, xhi, wx = axis_weights(w, ow)
    left, right = x[..., xlo], x[..., xhi]
    return left + wx * (right - left)


def _resize_half_pixel(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """[B, C, H, W] bilinear with half-pixel centres and no antialiasing
    (torch's ``align_corners=False``), as ``jax.image.resize(...,
    "bilinear", antialias=False)`` computes it."""
    return _resize(x.permute(0, 2, 3, 1), (oh, ow), _triangle,
                   antialias=False).permute(0, 3, 1, 2)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def forward(self, x):
        b, t, d = x.shape
        hd = d // self.heads

        def split(z):
            return z.reshape(b, t, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(
            self.value(x))
        attn = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(hd), dim=-1)
        return (attn @ v).transpose(1, 2).reshape(b, t, d)


class _ViTLayer(nn.Module):
    """Pre-LN ViT block (``modeling_dpt.py`` DPTViTLayer)."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layernorm_before = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attention = nn.Module()
        self.attention.attention = _SelfAttention(cfg)
        self.attention.output = nn.Module()
        self.attention.output.dense = nn.Linear(d, d)
        self.layernorm_after = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(d, cfg.mlp_dim)
        self.output = nn.Module()
        self.output.dense = nn.Linear(cfg.mlp_dim, d)

    def forward(self, x):
        o = self.attention.attention(self.layernorm_before(x))
        x = x + self.attention.output.dense(o)
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)


class _Residual(nn.Module):
    """DPTPreActResidualLayer: relu-conv-relu-conv plus the input."""

    def __init__(self, f: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(f, f, 3, padding=1)
        self.convolution2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        h = self.convolution1(F.relu(x))
        return x + self.convolution2(F.relu(h))


class _FusionLayer(nn.Module):
    def __init__(self, f: int, first: bool):
        super().__init__()
        self.projection = nn.Conv2d(f, f, 1)
        # Layer 0 has no residual input: its residual_layer1 never runs.
        self.residual_layer1 = None if first else _Residual(f)
        self.residual_layer2 = _Residual(f)


class _ReassembleLayer(nn.Module):
    def __init__(self, cfg: DPTConfig, si: int):
        super().__init__()
        c, fac = cfg.neck_hidden_sizes[si], cfg.reassemble_factors[si]
        self.projection = nn.Conv2d(cfg.hidden_size, c, 1)
        if fac > 1:
            self.resize = nn.ConvTranspose2d(c, c, int(fac), stride=int(fac))
        elif fac < 1:
            self.resize = nn.Conv2d(c, c, 3, stride=int(round(1 / fac)),
                                    padding=1)
        else:
            self.resize = nn.Identity()


class DPTDepth(nn.Module):
    """DPTForDepthEstimation forward (readout "project", the dpt-large
    graph)."""

    def __init__(self, cfg: DPTConfig = DPTConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        d, grid = cfg.hidden_size, cfg.image_size // cfg.patch_size
        self.dpt = nn.Module()
        emb = self.dpt.embeddings = nn.Module()
        emb.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        emb.position_embeddings = nn.Parameter(
            torch.zeros(1, grid * grid + 1, d))
        emb.patch_embeddings = nn.Module()
        emb.patch_embeddings.projection = nn.Conv2d(
            3, d, cfg.patch_size, stride=cfg.patch_size)
        self.dpt.encoder = nn.Module()
        self.dpt.encoder.layer = nn.ModuleList(
            _ViTLayer(cfg) for _ in range(cfg.num_layers))
        n = len(cfg.out_indices)
        f = cfg.fusion_hidden_size
        self.neck = nn.Module()
        rs = self.neck.reassemble_stage = nn.Module()
        rs.readout_projects = nn.ModuleList(
            nn.Sequential(nn.Linear(2 * d, d), nn.GELU()) for _ in range(n))
        rs.layers = nn.ModuleList(_ReassembleLayer(cfg, si)
                                  for si in range(n))
        self.neck.convs = nn.ModuleList(
            nn.Conv2d(c, f, 3, padding=1, bias=False)
            for c in cfg.neck_hidden_sizes)
        self.neck.fusion_stage = nn.Module()
        self.neck.fusion_stage.layers = nn.ModuleList(
            _FusionLayer(f, j == 0) for j in range(n))
        self.head = nn.Module()
        self.head.head = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU())
        if device is not None:
            self.to(device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [B, H, W, 3] normalised -> depth [B, H, W]."""
        c = self.cfg
        b, h, w, _ = pixels.shape
        ph, pw = h // c.patch_size, w // c.patch_size
        emb = self.dpt.embeddings
        tok = emb.patch_embeddings.projection(pixels.permute(0, 3, 1, 2))
        tok = tok.flatten(2).transpose(1, 2)
        grid0 = c.image_size // c.patch_size
        pos = emb.position_embeddings
        pos_grid = pos[:, 1:].reshape(1, grid0, grid0, -1).permute(0, 3, 1, 2)
        pos_grid = _resize_half_pixel(pos_grid, ph, pw).flatten(2).transpose(
            1, 2)
        x = torch.cat([emb.cls_token.expand(b, -1, -1), tok], dim=1)
        x = x + torch.cat([pos[:, :1], pos_grid], dim=1)

        taps: Dict[int, torch.Tensor] = {}
        for i, layer in enumerate(self.dpt.encoder.layer):
            x = layer(x)
            if i in c.out_indices:
                taps[i] = x

        rs = self.neck.reassemble_stage
        feats = []
        for si, li in enumerate(c.out_indices):
            t = taps[li]
            grid = t[:, 1:]
            g = rs.readout_projects[si](torch.cat(
                [grid, t[:, :1].expand_as(grid)], dim=-1))
            g = g.transpose(1, 2).reshape(b, -1, ph, pw)
            layer = rs.layers[si]
            g = layer.resize(layer.projection(g))
            feats.append(self.neck.convs[si](g))

        fused = None
        for j, layer in enumerate(self.neck.fusion_stage.layers):
            stage = feats[len(feats) - 1 - j]
            if fused is None:
                fused = stage
            else:
                if fused.shape[2:] != stage.shape[2:]:
                    stage = _resize_half_pixel(stage, *fused.shape[2:])
                fused = fused + layer.residual_layer1(stage)
            fused = layer.residual_layer2(fused)
            fused = _resize_align_corners(fused, fused.shape[2] * 2,
                                          fused.shape[3] * 2)
            fused = layer.projection(fused)

        head = self.head.head
        y = head[0](fused)
        y = _resize_align_corners(y, y.shape[2] * 2, y.shape[3] * 2)
        y = head[5](head[4](head[3](head[2](y))))
        return y[:, 0]


# --- weights --------------------------------------------------------------

_DROPPED = ("dpt.layernorm.weight", "dpt.layernorm.bias")


def _dropped(key: str) -> bool:
    """Keys of a ``DPTForDepthEstimation`` state dict that feed nothing
    the depth head reads."""
    return key in _DROPPED or key.startswith(
        "neck.fusion_stage.layers.0.residual_layer1.")


def import_dpt(model: DPTDepth, sd: Dict) -> DPTDepth:
    """Load a ``DPTForDepthEstimation`` state dict (non-hybrid, readout
    "project") into ``model`` with total coverage: raises on an
    unconsumed key, an unfilled parameter or a shape mismatch."""
    own = model.state_dict()
    unused = sorted(k for k in sd if k not in own
                    and not _dropped(k))
    if unused:
        raise ValueError(f"unconsumed torch keys: {unused[:8]}"
                         f" (+{max(0, len(unused) - 8)} more)")
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise ValueError(f"param mismatch: missing={missing[:6]}")
    with torch.no_grad():
        for k, t in own.items():
            v = torch.as_tensor(np.asarray(sd[k]) if not isinstance(
                sd[k], torch.Tensor) else sd[k])
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch at {k}: {tuple(t.shape)} "
                                 f"vs {tuple(v.shape)}")
            t.copy_(v)
    return model


def infer_config(sd: Dict) -> DPTConfig:
    """The backbone geometry of a ``DPTForDepthEstimation`` state dict,
    from its tensor shapes (the JAX ``load_dpt_torch`` rule)."""
    shape = {k: tuple(v.shape) for k, v in sd.items()}
    hid = shape["dpt.embeddings.cls_token"][-1]
    n_layers = 1 + max(int(k.split(".")[3]) for k in sd
                       if k.startswith("dpt.encoder.layer."))
    mlp = shape["dpt.encoder.layer.0.intermediate.dense.weight"][0]
    patch = shape["dpt.embeddings.patch_embeddings.projection.weight"][-1]
    grid = int(round((shape["dpt.embeddings.position_embeddings"][1] - 1)
                     ** 0.5))
    n_necks = len([k for k in sd if k.startswith(
        "neck.reassemble_stage.layers.") and k.endswith("projection.weight")])
    necks = tuple(shape[f"neck.reassemble_stage.layers.{i}.projection."
                        f"weight"][0] for i in range(n_necks))
    fusion = shape["neck.convs.0.weight"][0]
    # out_indices spread evenly over the backbone (every HF config: large
    # (5, 11, 17, 23), base (2, 5, 8, 11)).
    step = n_layers // 4
    return DPTConfig(hidden_size=hid, num_layers=n_layers,
                     num_heads=max(1, hid // 64), mlp_dim=mlp,
                     patch_size=patch, image_size=grid * patch,
                     out_indices=tuple(step * (i + 1) - 1 for i in range(4)),
                     neck_hidden_sizes=necks, fusion_hidden_size=fusion)


def load_dpt_torch(path: str, cfg: Optional[DPTConfig] = None,
                   device=DEFAULT_DEVICE) -> Tuple[DPTConfig, DPTDepth]:
    """A torch ``DPTForDepthEstimation`` checkpoint file (a bare state
    dict or ``{"state_dict": ...}``, optionally with a ``"config"``
    entry) -> (cfg, model on ``device``, the card by default, which
    raises without one); the geometry is read off the tensor shapes when
    neither ``cfg`` nor the file gives it."""
    device = resolve_device(device)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    if cfg is None and isinstance(obj, dict) and "config" in obj:
        cfg = DPTConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in obj["config"].items()})
    if cfg is None:
        cfg = infer_config(sd)
    model = import_dpt(DPTDepth(cfg), sd).to(device).eval()
    return cfg, model.requires_grad_(False)


@torch.no_grad()
def estimate_depth(model: DPTDepth, rgb01: np.ndarray,
                   proc_size: int = 384) -> np.ndarray:
    """The HF depth-estimation pipeline around the model: resize to the
    processor grid (bicubic), normalise with mean and std 0.5, run,
    resize the prediction back to the source size (bicubic) and min-max
    it to [0, 1] (``gen_depth`` writes it as a 3-channel PNG)."""
    h, w = rgb01.shape[:2]
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(rgb01, np.float32), device=dev)[None]
    x = resize_bicubic(x, (proc_size, proc_size))
    d = model((x - 0.5) / 0.5)
    d = resize_bicubic(d[..., None], (h, w))
    d = d[0, ..., 0].cpu().numpy()
    lo, hi = float(d.min()), float(d.max())
    return (d - lo) / max(hi - lo, 1e-8)


def state_dict_from_jax(flat: Dict[str, np.ndarray],
                        cfg: DPTConfig = DPTConfig()
                        ) -> Dict[str, torch.Tensor]:
    """The JAX ``DPTDepth`` params, flat ``{"a/b/c": ndarray}``, as a
    state dict of ``DPTDepth`` (the HF key space): the inverse of the JAX
    ``import_dpt`` (Dense (I, O) -> (O, I), Conv HWIO -> OIHW, the
    transposed convs' (k, k, I, O) -> IOHW, LayerNorm scale -> weight)."""
    def conv(a):
        return a.transpose(3, 2, 0, 1)

    sd = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.array(arr, np.float32))

    emb = "dpt.embeddings."
    put(emb + "cls_token", flat["cls_token"])
    put(emb + "position_embeddings", flat["position_embeddings"])
    put(emb + "patch_embeddings.projection.weight",
        conv(flat["patch_embed/kernel"]))
    put(emb + "patch_embeddings.projection.bias", flat["patch_embed/bias"])
    for i in range(cfg.num_layers):
        t, f = f"dpt.encoder.layer.{i}.", f"layer_{i}/"
        for ln in ("layernorm_before", "layernorm_after"):
            put(t + ln + ".weight", flat[f + ln + "/scale"])
            put(t + ln + ".bias", flat[f + ln + "/bias"])
        for name, tq in (("query", "attention.attention.query"),
                         ("key", "attention.attention.key"),
                         ("value", "attention.attention.value"),
                         ("attn_out", "attention.output.dense"),
                         ("intermediate", "intermediate.dense"),
                         ("output", "output.dense")):
            put(t + tq + ".weight", flat[f + name + "/kernel"].T)
            put(t + tq + ".bias", flat[f + name + "/bias"])
    rs = "neck.reassemble_stage."
    for si, fac in enumerate(cfg.reassemble_factors):
        put(rs + f"readout_projects.{si}.0.weight",
            flat[f"readout_{si}/kernel"].T)
        put(rs + f"readout_projects.{si}.0.bias", flat[f"readout_{si}/bias"])
        put(rs + f"layers.{si}.projection.weight",
            conv(flat[f"reassemble_proj_{si}/kernel"]))
        put(rs + f"layers.{si}.projection.bias",
            flat[f"reassemble_proj_{si}/bias"])
        if fac != 1:
            k = flat[f"reassemble_resize_{si}/kernel"]
            put(rs + f"layers.{si}.resize.weight",
                k.transpose(2, 3, 0, 1) if fac > 1 else conv(k))
            put(rs + f"layers.{si}.resize.bias",
                flat[f"reassemble_resize_{si}/bias"])
        put(f"neck.convs.{si}.weight", conv(flat[f"neck_conv_{si}/kernel"]))
    for j in range(len(cfg.neck_hidden_sizes)):
        t = f"neck.fusion_stage.layers.{j}."
        put(t + "projection.weight", conv(flat[f"fusion_proj_{j}/kernel"]))
        put(t + "projection.bias", flat[f"fusion_proj_{j}/bias"])
        for rl, fl in (("residual_layer1", f"fusion_res1_{j}"),
                       ("residual_layer2", f"fusion_res2_{j}")):
            if rl == "residual_layer1" and j == 0:
                continue
            for ci in (1, 2):
                put(t + f"{rl}.convolution{ci}.weight",
                    conv(flat[f"{fl}/conv{ci}/kernel"]))
                put(t + f"{rl}.convolution{ci}.bias",
                    flat[f"{fl}/conv{ci}/bias"])
    for name, tk in (("head_conv1", "head.head.0"),
                     ("head_conv2", "head.head.2"),
                     ("head_conv3", "head.head.4")):
        put(tk + ".weight", conv(flat[f"{name}/kernel"]))
        put(tk + ".bias", flat[f"{name}/bias"])
    return sd
