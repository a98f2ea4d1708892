"""Text-grounded object localisation with CLIP (PyTorch).

Port of ``multiview_inpaint_tpu/guidance/grounding.py``, the stand-in for
the reference's Grounding-DINO detector
(``Segment-and-Track-Anything-Supplementary-Code/seg_gs.py:94-117``):
score a multi-scale sliding-window pyramid of crops against a text
embedding (cosine similarity in CLIP's shared space) and return the best
window. The crops are grouped by size, each group resized to the vision
tower's input in one batched ``resize_bilinear`` (``jax.image.resize``
bilinear), and the whole pyramid goes through the vision tower in one
batched forward. The towers (``diffusion/clip_vit``,
``diffusion/clip_text``) attend by plain matmul, as the JAX towers do.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diffusion import checkpoint
from ..diffusion.clip_text import CLIPTextTower, SimpleTokenizer, TextConfig
from ..diffusion.clip_vit import CLIPVisionTower, ViTConfig, resize_bilinear
from ..utils.device import DEFAULT_DEVICE, resolve_device


def grounding_windows(h: int, w: int,
                      scales: Sequence[float] = (0.7, 0.5, 0.35),
                      stride_frac: float = 0.5) -> np.ndarray:
    """[K, 4] int boxes (y0, x0, y1, x1): a sliding pyramid at the given
    scales of min(h, w), plus the full frame."""
    boxes = [(0, 0, h, w)]
    base = min(h, w)
    for s in scales:
        win = max(16, int(round(base * s)))
        step = max(1, int(round(win * stride_frac)))
        ys = list(range(0, max(h - win, 0) + 1, step))
        xs = list(range(0, max(w - win, 0) + 1, step))
        if ys and ys[-1] != h - win and h > win:
            ys.append(h - win)
        if xs and xs[-1] != w - win and w > win:
            xs.append(w - win)
        for y0 in ys:
            for x0 in xs:
                boxes.append((y0, x0, y0 + win, x0 + win))
    return np.asarray(boxes, np.int32)


def tower_from_jax(flat: Dict[str, np.ndarray], cfg, component: str,
                   device=DEFAULT_DEVICE):
    """A CLIP tower (``component`` "clip": vision, "clip_text": text) of
    config ``cfg`` from the JAX tower's flat params ``{"a/b": array}``,
    in f32 on ``device``."""
    dev = resolve_device(device)
    prefix = checkpoint.PREFIXES.get(component, checkpoint.TEXT_PREFIX)
    sd = {k[len(prefix):]: v.float() for k, v in
          checkpoint.state_dict_from_jax(flat, component).items()}
    tower = (CLIPVisionTower if component == "clip" else CLIPTextTower)(
        cfg, device=dev)
    tower.load_state_dict(sd)
    return tower.eval().requires_grad_(False)


def text_config_of(flat: Dict[str, np.ndarray]) -> TextConfig:
    """The geometry of a JAX text tower's flat params (``TextConfig()``'s
    for the OpenCLIP-H tower)."""
    vocab, width = np.shape(flat["token_embedding/embedding"])
    layers = len({k.split("/")[0] for k in flat
                  if k.startswith("resblocks_")})
    return TextConfig(
        vocab_size=vocab,
        context_length=np.shape(flat["positional_embedding"])[0],
        width=width, layers=layers,
        heads=np.shape(flat["resblocks_0/attn/query/kernel"])[1],
        output_dim=np.shape(flat["text_projection"])[1])


class CLIPGrounder:
    """Callable: (image [H, W, 3] in [0, 1], text or text embedding) ->
    (best box (y0, x0, y1, x1), per-window scores).

    ``vision`` is a :class:`CLIPVisionTower`; ``text`` (a
    :class:`CLIPTextTower`) and a BPE merges file ``bpe_path`` unlock
    plain-text queries. Pass a precomputed text-embedding row instead of
    a string to skip the text tower. Everything runs on the vision
    tower's device, in its parameters' type."""

    def __init__(self, vision: CLIPVisionTower,
                 text: Optional[CLIPTextTower] = None,
                 bpe_path: Optional[str] = None):
        self.vit = vision
        self.text = text
        self.bpe_path = bpe_path
        self._tokenizer = None

    @classmethod
    def from_jax_params(cls, vision_params: Dict[str, np.ndarray],
                        vit_cfg: Optional[ViTConfig] = None,
                        text_params: Optional[Dict[str, np.ndarray]] = None,
                        text_cfg: Optional[TextConfig] = None,
                        bpe_path: Optional[str] = None,
                        device=DEFAULT_DEVICE) -> "CLIPGrounder":
        """The JAX ``CLIPGrounder(vision_params, vit_cfg, text_params,
        text_cfg, bpe_path)``: flat JAX tower params, carried over. The
        text tower's geometry is read off its params unless given."""
        vision = tower_from_jax(vision_params, vit_cfg or ViTConfig(),
                                "clip", device)
        text = (None if text_params is None else tower_from_jax(
            text_params, text_cfg or text_config_of(text_params),
            "clip_text", device))
        return cls(vision, text, bpe_path)

    @property
    def device(self) -> torch.device:
        return self.vit.proj.device

    @property
    def dtype(self) -> torch.dtype:
        return self.vit.proj.dtype

    def text_features(self, text: str) -> torch.Tensor:
        if self.text is None or self.bpe_path is None:
            raise ValueError(
                "text queries need text_params + bpe_path (external "
                "OpenCLIP artifacts); pass text_features directly "
                "otherwise")
        if self._tokenizer is None:
            self._tokenizer = SimpleTokenizer(self.bpe_path,
                                              self.text.cfg.context_length)
        toks = torch.from_numpy(self._tokenizer([text])).to(self.device)
        with torch.no_grad():
            return self.text(toks)[1][0]

    def crops(self, image: np.ndarray, windows: np.ndarray) -> torch.Tensor:
        """[K, S, S, 3] window crops at the vision tower's input size S:
        one batched bilinear resize per window size."""
        size = self.vit.cfg.image_size
        img = torch.as_tensor(np.asarray(image, np.float32),
                              device=self.device).to(self.dtype)
        out = torch.empty((len(windows), size, size, 3), dtype=self.dtype,
                          device=self.device)
        sizes = {}
        for k, (y0, x0, y1, x1) in enumerate(windows):
            sizes.setdefault((y1 - y0, x1 - x0), []).append(k)
        for ks in sizes.values():
            batch = torch.stack([img[windows[k][0]:windows[k][2],
                                     windows[k][1]:windows[k][3]]
                                 for k in ks])
            out[torch.as_tensor(ks, device=self.device)] = resize_bilinear(
                batch, (size, size))
        return out

    def scores(self, crops: torch.Tensor, tfeat: torch.Tensor
               ) -> torch.Tensor:
        """Cosine similarity of each crop's embedding with ``tfeat``."""
        with torch.no_grad():
            emb = self.vit(crops * 2.0 - 1.0)               # [K, D]
        emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
        tfeat = tfeat.to(emb) / torch.linalg.norm(tfeat.to(emb))
        return emb @ tfeat

    def __call__(self, image: np.ndarray, text,
                 windows: Optional[np.ndarray] = None
                 ) -> Tuple[Tuple[int, int, int, int], np.ndarray]:
        h, w = image.shape[:2]
        if windows is None:
            windows = grounding_windows(h, w)
        tfeat = (self.text_features(text) if isinstance(text, str)
                 else torch.as_tensor(np.asarray(text), device=self.device))
        scores = self.scores(self.crops(image, windows), tfeat).cpu().numpy()
        best = windows[int(np.argmax(scores))]
        return tuple(int(v) for v in best), scores


def filter_components(mask: np.ndarray, region: np.ndarray,
                      min_overlap: float = 0.05) -> np.ndarray:
    """Keep the connected components of ``mask`` that overlap ``region``
    (a binary map) by at least ``min_overlap`` of their area: the 'segment
    only the named object' step the reference delegates to Grounding-DINO
    boxes feeding SAM."""
    from scipy import ndimage

    labels, n = ndimage.label(mask > 0.5)
    if n == 0:
        return mask
    keep = np.zeros_like(mask)
    for lab in range(1, n + 1):
        comp = labels == lab
        if region[comp].mean() >= min_overlap:
            keep[comp] = 1.0
    return keep


def box_to_mask(box: Tuple[int, int, int, int], h: int,
                w: int) -> np.ndarray:
    y0, x0, y1, x1 = box
    m = np.zeros((h, w), np.float32)
    m[max(y0, 0):min(y1, h), max(x0, 0):min(x1, w)] = 1.0
    return m
