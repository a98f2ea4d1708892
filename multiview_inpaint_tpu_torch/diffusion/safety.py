"""Output safety filtering: the reference's ``scripts/util/detection/
nsfw_and_watermark_dectection.py`` (DeepFloydDataFiltering).

Copy of ``multiview_inpaint_tpu/diffusion/safety.py`` (numpy only, so the
port keeps its own).

Same mechanism: CLIP image embeddings scored by small linear heads
(nsfw + watermark logistic probes); frames above threshold are blurred.
The heads' weights load from the DeepFloyd probe files via
:func:`load_heads`; without them the filter is a configurable no-op that
still reports scores=0 (zero-egress default).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np


class SafetyFilter:
    def __init__(self, img_embed: Optional[Callable] = None,
                 heads: Optional[Dict[str, np.ndarray]] = None,
                 nsfw_threshold: float = 0.5,
                 watermark_threshold: float = 0.5):
        self.img_embed = img_embed
        self.heads = heads or {}
        self.nsfw_threshold = nsfw_threshold
        self.watermark_threshold = watermark_threshold

    def scores(self, image: np.ndarray) -> Dict[str, float]:
        if self.img_embed is None or not self.heads:
            return {"nsfw": 0.0, "watermark": 0.0}
        emb = np.asarray(self.img_embed(image)).reshape(-1)
        emb = emb / (np.linalg.norm(emb) + 1e-9)
        out = {}
        for name in ("nsfw", "watermark"):
            if name in self.heads:
                w = self.heads[name]
                logit = float(emb @ w[:-1] + w[-1])
                out[name] = 1.0 / (1.0 + np.exp(-logit))
            else:
                out[name] = 0.0
        return out

    def __call__(self, image: np.ndarray) -> np.ndarray:
        s = self.scores(image)
        if (s["nsfw"] > self.nsfw_threshold
                or s["watermark"] > self.watermark_threshold):
            return _box_blur(image, k=9)
        return image


def _box_blur(img: np.ndarray, k: int = 9) -> np.ndarray:
    pad = k // 2
    p = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    out = np.zeros_like(img)
    for dy in range(k):
        for dx in range(k):
            out += p[dy:dy + img.shape[0], dx:dx + img.shape[1]]
    return out / (k * k)


def load_heads(path: str) -> Dict[str, np.ndarray]:
    """npz with 'nsfw' / 'watermark' rows: [D+1] (weights + bias)."""
    z = np.load(path)
    return {k: np.asarray(z[k]) for k in z.files}
