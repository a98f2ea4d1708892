"""Evaluation metrics — counterpart of
``multiview_inpaint_tpu/metrics/metrics.py``.

PSNR (masked and unmasked), Laplacian sharpness and the CLIP similarity
helpers are numpy and copied as they are; the similarity helpers take
injected embedding callables (any CLIP implementation plugs in). SSIM
goes through the port's ``utils/losses.ssim``. The image-quality
networks are ``lpips``, ``musiq`` and ``wadiqam`` beside this module.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils import losses as loss_utils


def psnr(img1: np.ndarray, img2: np.ndarray,
         mask: Optional[np.ndarray] = None) -> float:
    """[H,W,3] in [0,1]; mask [H,W] selects evaluated pixels (1=keep)."""
    diff = (img1 - img2) ** 2
    if mask is not None:
        m = mask[..., None]
        mse = (diff * m).sum() / (m.sum() * img1.shape[-1] + 1e-9)
    else:
        mse = diff.mean()
    return float(20 * np.log10(1.0 / np.sqrt(mse + 1e-12)))


def ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """Mean SSIM of two [H, W, 3] images in [0, 1] (on the CPU)."""
    def chw(img):
        return torch.from_numpy(np.ascontiguousarray(
            img.transpose(2, 0, 1), np.float32))

    return float(loss_utils.ssim(chw(img1), chw(img2)))


def laplacian_sharpness(img: np.ndarray) -> float:
    """Variance of the 3x3 Laplacian response of the grayscale image."""
    gray = img @ np.array([0.299, 0.587, 0.114])
    k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
    h, w = gray.shape
    out = np.zeros((h - 2, w - 2), np.float32)
    for dy in range(3):
        for dx in range(3):
            out += k[dy, dx] * gray[dy:h - 2 + dy, dx:w - 2 + dx]
    return float(out.var())


def text_img_similarity(img_embed: Callable, text_embed: Callable,
                        images: Sequence[np.ndarray], text: str) -> float:
    """Mean cosine similarity between image embeddings and the prompt."""
    t = _norm(text_embed(text))
    sims = [float(_norm(img_embed(im)) @ t) for im in images]
    return float(np.mean(sims))


def directional_similarity(img_embed: Callable, text_embed: Callable,
                           src_images: Sequence[np.ndarray],
                           dst_images: Sequence[np.ndarray],
                           src_text: str, dst_text: str) -> float:
    """CLIP-direction consistency: cos(delta_img, delta_text)."""
    dt = _norm(text_embed(dst_text) - text_embed(src_text))
    sims = []
    for a, b in zip(src_images, dst_images):
        di = img_embed(b) - img_embed(a)
        sims.append(float(_norm(di) @ dt))
    return float(np.mean(sims))


def temporal_similarity(img_embed: Callable,
                        images: Sequence[np.ndarray]) -> float:
    """Mean cosine similarity of consecutive frame embeddings."""
    embs = [_norm(img_embed(im)) for im in images]
    return float(np.mean([embs[i] @ embs[i + 1]
                          for i in range(len(embs) - 1)]))


def _norm(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float64).reshape(-1)
    return v / (np.linalg.norm(v) + 1e-12)
