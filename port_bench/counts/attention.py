"""Least time of the flash-attention forward kernel at one call's shape.

K4: 4 B H T^2 D FLOP (q.k and p.v) at the bf16 tensor-core peak,
B H T^2 exponentials at the special-function rate, or its bytes (q, k, v
read and o written once), whichever is longest."""

from __future__ import annotations

from .peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S, SFU_OP_PER_S


def k4_flop(b, h, t, d) -> float:
    return 4.0 * b * h * t * t * d


def k4_bound_s(b, h, t, d, elem_bytes: int = 2) -> float:
    ops = max(k4_flop(b, h, t, d) / BF16_FLOP_PER_S,
              b * h * t * t / SFU_OP_PER_S)
    return max(ops, 4.0 * b * t * h * d * elem_bytes / HBM_BYTES_PER_S)

