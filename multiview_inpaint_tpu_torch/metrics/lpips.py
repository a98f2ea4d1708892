"""LPIPS perceptual distance (VGG16 backbone) — counterpart of
``multiview_inpaint_tpu/metrics/lpips.py`` (reference
``gs-simp/lpipsPyTorch``).

The VGG16 feature trunk (13 conv3x3 + ReLU in ``_STAGES``, 2x2 max pool
between stages, the last ReLU of each stage tapped) and the LPIPS recipe:
the shift/scale of the inputs, each tap unit-normalised over its
channels, the squared difference reweighted by a 1x1 ``lin`` conv without
bias, its spatial mean, summed over the five taps. NHWC in, NCHW inside.

Module names are the JAX tree's (``vgg.conv_0`` ... ``vgg.conv_12``,
``lin_0`` ... ``lin_4``), so ``checkpoint.flax_to_torch`` carries JAX
params over (``load_lpips_npz`` reads the npz layout ``vae_finetune``
loads); ``import_torch_weights`` reads torchvision's ``vgg16`` and the
lpips ``vgg.pth`` state dicts as the JAX importer does. ``load_lpips_npz``
unpickles: open only files you trust.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion import checkpoint
from ..utils.device import DEFAULT_DEVICE, resolve_device

# VGG16 conv plan: (out_channels, layers) per stage; relu at each conv,
# maxpool between stages. LPIPS taps the last relu of each stage.
_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
# torchvision ``vgg16().features`` indices of the 13 convs, in order.
_TORCHVISION_CONVS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


class VGG16Features(nn.Module):
    def __init__(self, **factory):
        super().__init__()
        cin, i = 3, 0
        for ch, n_layers in _STAGES:
            for _ in range(n_layers):
                setattr(self, f"conv_{i}",
                        nn.Conv2d(cin, ch, 3, padding=1, **factory))
                cin, i = ch, i + 1

    def forward(self, x) -> List[torch.Tensor]:
        """x [B, 3, H, W] -> the five stage taps (NCHW)."""
        feats = []
        i = 0
        for stage, (_, n_layers) in enumerate(_STAGES):
            for _ in range(n_layers):
                x = F.relu(getattr(self, f"conv_{i}")(x))
                i += 1
            feats.append(x)
            if stage != len(_STAGES) - 1:
                x = F.max_pool2d(x, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self, **factory):
        super().__init__()
        self.vgg = VGG16Features(**factory)
        for i, (ch, _) in enumerate(_STAGES):
            setattr(self, f"lin_{i}",
                    nn.Conv2d(ch, 1, 1, bias=False, **factory))
        dev = factory.get("device")
        self.register_buffer("shift", torch.tensor(_SHIFT, device=dev).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=dev).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, a, b):
        """a, b: [B, H, W, 3] in [-1, 1] -> [B] distances."""
        a = (a.permute(0, 3, 1, 2) - self.shift) / self.scale
        b = (b.permute(0, 3, 1, 2) - self.shift) / self.scale
        total = 0.0
        for i, (x, y) in enumerate(zip(self.vgg(a), self.vgg(b))):
            x = x / torch.linalg.vector_norm(
                x, dim=1, keepdim=True).clamp_min(1e-10)
            y = y / torch.linalg.vector_norm(
                y, dim=1, keepdim=True).clamp_min(1e-10)
            w = getattr(self, f"lin_{i}")((x - y) ** 2)
            total = total + w.mean(dim=(1, 2, 3))
        return total


def import_torch_weights(vgg_state: Dict, lpips_state: Dict
                         ) -> Dict[str, torch.Tensor]:
    """torchvision vgg16 ``features.N.weight`` + lpips ``lin{i}.model.1``
    (or ``lins.{i}.model.1``) -> an ``LPIPS`` state dict (partial where
    the lpips file lacks a lin, as the JAX importer leaves it)."""
    sd = {}
    for ci, ti in enumerate(_TORCHVISION_CONVS):
        sd[f"vgg.conv_{ci}.weight"] = torch.as_tensor(
            np.asarray(vgg_state[f"features.{ti}.weight"]))
        sd[f"vgg.conv_{ci}.bias"] = torch.as_tensor(
            np.asarray(vgg_state[f"features.{ti}.bias"]))
    for i in range(len(_STAGES)):
        for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if k in lpips_state:
                sd[f"lin_{i}.weight"] = torch.as_tensor(
                    np.asarray(lpips_state[k]))
                break
    return sd


def load_lpips_npz(path: str, device=DEFAULT_DEVICE) -> LPIPS:
    """The LPIPS weights file ``vae_finetune --lpips_ckpt`` reads, an npz
    whose ``params`` entry is the pickled JAX params tree, as a frozen
    ``LPIPS`` on ``device`` (the card by default; raises without one)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=True) as z:
        tree = z["params"].item()
    model = LPIPS(device=device)
    model.load_state_dict(checkpoint.flax_to_torch(
        checkpoint.flatten_tree(tree)))
    return model.requires_grad_(False).eval()
