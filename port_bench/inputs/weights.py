"""Seeded weights for a network given as (key, shape) pairs.

The values come from a few bulk draws of a ``torch.Generator`` on the
device, one flat buffer per storage type, each key a view of it scaled
by its fan-in: matrices and kernels get N(0, 1/fan_in), one-dimensional
weights (norm gains) 1 + N(0, 0.1^2), every other vector (biases, mix
factors, embeddings) N(0, 0.02^2). Zero-initialised layers of the
published init get random values too, so every branch (the ControlNet's
zero convs included) carries signal. The same seed gives the same values
on every call, so the program and the reference get the same weights.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 30


def _scale(key: str, shape) -> tuple:
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if key.endswith("weight"):
        return 0.1, 1.0
    return 0.02, 0.0


def seeded(spec, seed: int, device, dtype_of) -> dict:
    """``spec``: [(key, shape)]; ``dtype_of(key)``: the storage type of
    each key. Returns {key: tensor}, views of one buffer per type."""
    groups = {}
    for key, shape in spec:
        groups.setdefault(dtype_of(key), []).append((key, tuple(shape)))
    out = {}
    for i, (dtype, items) in enumerate(sorted(groups.items(),
                                              key=lambda kv: str(kv[0]))):
        g = torch.Generator(device=device).manual_seed(seed + i)
        total = sum(math.prod(s) for _, s in items)
        flat = torch.empty(total, dtype=dtype, device=device)
        for lo in range(0, total, CHUNK):
            flat[lo:lo + CHUNK].normal_(generator=g)
        offset = 0
        for key, shape in items:
            n = math.prod(shape)
            view = flat[offset:offset + n].view(shape)
            std, mean = _scale(key, shape)
            view.mul_(std).add_(mean)
            out[key] = view
            offset += n
    return out
