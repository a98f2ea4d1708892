"""WaDIQaM-NR, weighted-average deep image quality (no reference) —
counterpart of ``multiview_inpaint_tpu/metrics/wadiqam.py`` (Bosse et
al., IEEE TIP 2018; the reference scores renders with pyiqa's
``wadiqam_nr``).

The image is cropped to whole 32x32 patches and cut into the
deterministic non-overlapping grid, in the JAX module's order (patch row,
then patch column); each patch runs a VGG-like trunk (conv3x3 pairs at
32/64/128/256/512 channels, a 2x2 max pool after each pair) down to a
512-d descriptor; a quality head (FC 512-512-1) scores each patch and a
weight head (FC 512-512-1, ReLU + 1e-6) rates it; the image score is
sum(a_i h_i) / sum(a_i). NHWC in, NCHW inside.

Module names are the JAX tree's (``trunk.conv0`` ... ``trunk.conv9``,
``fc1_q``, ``fc2_q``, ``fc1_w``, ``fc2_w``): ``checkpoint.flax_to_torch``
carries JAX params over, ``import_wadiqam`` reads a torch state dict.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion import checkpoint
from ..utils.device import DEFAULT_DEVICE, resolve_device

_CHANNELS = (32, 64, 128, 256, 512)
PATCH = 32


class PatchTrunk(nn.Module):
    """Conv3x3 pair + maxpool per stage; [P, 3, 32, 32] -> [P, 512]."""

    def __init__(self, **factory):
        super().__init__()
        cin = 3
        for i, ch in enumerate(_CHANNELS):
            setattr(self, f"conv{2 * i}",
                    nn.Conv2d(cin, ch, 3, padding=1, **factory))
            setattr(self, f"conv{2 * i + 1}",
                    nn.Conv2d(ch, ch, 3, padding=1, **factory))
            cin = ch

    def forward(self, x):
        for i in range(len(_CHANNELS)):
            x = F.relu(getattr(self, f"conv{2 * i}")(x))
            x = F.relu(getattr(self, f"conv{2 * i + 1}")(x))
            x = F.max_pool2d(x, 2)
        return x.reshape(x.shape[0], -1)      # [P, 512] (512x1x1)


class WaDIQaMNR(nn.Module):
    """[B, H, W, 3] in [0, 1] -> [B] quality scores."""

    def __init__(self, **factory):
        super().__init__()
        self.trunk = PatchTrunk(**factory)
        self.fc1_q = nn.Linear(512, 512, **factory)
        self.fc2_q = nn.Linear(512, 1, **factory)
        self.fc1_w = nn.Linear(512, 512, **factory)
        self.fc2_w = nn.Linear(512, 1, **factory)

    def forward(self, img):
        b, h, w, _ = img.shape
        hp, wp = h // PATCH, w // PATCH
        assert hp > 0 and wp > 0, "image smaller than one 32x32 patch"
        img = img[:, : hp * PATCH, : wp * PATCH]
        patches = img.reshape(b, hp, PATCH, wp, PATCH, 3).permute(
            0, 1, 3, 5, 2, 4).reshape(b * hp * wp, 3, PATCH, PATCH)
        feat = self.trunk(patches)                          # [B*P, 512]
        hq = self.fc2_q(F.relu(self.fc1_q(feat)))           # patch scores
        ha = F.relu(self.fc2_w(F.relu(self.fc1_w(feat)))) + 1e-6
        hq = hq.reshape(b, hp * wp)
        ha = ha.reshape(b, hp * wp)
        return torch.sum(ha * hq, dim=1) / torch.sum(ha, dim=1)


class WaDIQaMScorer:
    """numpy [H, W, 3] in [0, 1] -> float, on ``device``; ``params`` are
    JAX params (a nested tree or flat ``{"a/b": ndarray}``, as
    ``checkpoint.load_params`` reads the JAX npz); ``device`` defaults to
    the card and raises without one."""

    def __init__(self, params: Dict, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.model = WaDIQaMNR(device=self.device)
        self.model.load_state_dict(checkpoint.flax_to_torch(
            checkpoint.flatten_tree(params)))
        self.model.requires_grad_(False).eval()

    def __call__(self, img: np.ndarray) -> float:
        x = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        with torch.no_grad():
            return float(self.model(x[None])[0])


# torch key prefixes of the common port (pyiqa wadiqam_arch naming);
# conv trunk keys are positional, heads are named.
_TORCH_HEADS = {
    "fc1_q": "fc1_q", "fc2_q": "fc2_q",
    "fc1_w": "fc1_w", "fc2_w": "fc2_w",
}


def import_wadiqam(state: Dict, head_map: Dict = _TORCH_HEADS
                   ) -> Dict[str, torch.Tensor]:
    """torch state dict -> a ``WaDIQaMNR`` state dict: the ten trunk convs
    as ``features.{k}.weight/bias`` in layer order (k the Sequential
    indices), the head FCs as ``{name}.weight/bias`` through
    ``head_map`` (ours -> theirs)."""
    conv_keys = sorted(
        (k for k in state if k.startswith("features.")
         and k.endswith(".weight") and np.ndim(state[k]) == 4),
        key=lambda k: int(k.split(".")[1]))
    assert len(conv_keys) == 10, f"expected 10 convs, got {conv_keys}"
    sd = {}
    for i, wk in enumerate(conv_keys):
        sd[f"trunk.conv{i}.weight"] = torch.as_tensor(np.asarray(state[wk]))
        sd[f"trunk.conv{i}.bias"] = torch.as_tensor(
            np.asarray(state[wk.replace(".weight", ".bias")]))
    for ours, theirs in head_map.items():
        for leaf in ("weight", "bias"):
            sd[f"{ours}.{leaf}"] = torch.as_tensor(
                np.asarray(state[f"{theirs}.{leaf}"]))
    return sd
