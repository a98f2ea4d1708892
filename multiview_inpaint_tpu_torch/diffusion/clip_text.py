"""OpenCLIP text tower and the CLIP byte-pair-encoding tokenizer (PyTorch).

Counterpart of ``multiview_inpaint_tpu/diffusion/clip_text.py``:

- :class:`CLIPTextTower`: token embedding plus a learned positional
  embedding, a causal pre-LN transformer (LayerNorm eps 1e-6 as flax
  uses, the exact GELU, attention by plain matmul and softmax) and a final
  LayerNorm; returns the full token sequence and the pooled projection at
  the end-of-text token (the highest id of each row). The defaults are the
  OpenCLIP-H text tower: width 1024, 23 layers, 16 heads, context 77.
  Parameter names are OpenCLIP's (``token_embedding``,
  ``positional_embedding``, ``transformer.resblocks.N.*`` as in the vision
  tower, ``ln_final``, ``text_projection``); ``diffusion.checkpoint``
  carries the JAX tower's leaves into them.
- :class:`SimpleTokenizer`: the standard CLIP BPE (lowercase, bytes to
  unicode, merges) on a merges file the user supplies
  (``bpe_simple_vocab_16e6.txt[.gz]``), standard library only, a copy of
  the JAX package's.
"""

from __future__ import annotations

import dataclasses
import gzip
import html
import re
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from .clip_vit import LN_EPS, ResidualAttentionBlock, _layer_norm


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 1024        # SD2 / OpenCLIP-H text width
    layers: int = 23
    heads: int = 16
    output_dim: int = 1024


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: TextConfig = TextConfig(), **factory):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width,
                                            **factory)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(cfg.context_length, cfg.width, **factory))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads, **factory)
            for _ in range(cfg.layers))
        self.ln_final = nn.LayerNorm(cfg.width, eps=LN_EPS, **factory)
        self.text_projection = nn.Parameter(
            0.01 * torch.randn(cfg.width, cfg.output_dim, **factory))

    def forward(self, tokens: torch.Tensor):
        """tokens [B, L] int -> (hidden [B, L, W], pooled [B, D])."""
        b, n = tokens.shape
        x = (self.token_embedding(tokens.long())
             + self.positional_embedding[None, :n])
        causal = torch.ones((n, n), dtype=torch.bool,
                            device=tokens.device).tril()
        for blk in self.transformer.resblocks:
            x = blk(x, causal)
        hidden = _layer_norm(self.ln_final, x)
        eot = tokens.argmax(dim=-1)     # the highest id is the eot token
        pooled = hidden[torch.arange(b, device=tokens.device), eot] \
            @ self.text_projection.to(hidden.dtype)
        return hidden, pooled


@lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class SimpleTokenizer:
    """CLIP BPE tokenizer; ``bpe_path`` is the standard merges file
    (``bpe_simple_vocab_16e6.txt[.gz]``)."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read()
        else:
            with open(bpe_path, encoding="utf-8") as f:
                merges = f.read()
        merges = merges.split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(_bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text).strip().lower()
        bpe_tokens: List[int] = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t]
                              for t in self._bpe(token).split(" "))
        return bpe_tokens

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            toks = [sot] + self.encode(t)[:self.context_length - 2] + [eot]
            out[i, :len(toks)] = toks
        return out
