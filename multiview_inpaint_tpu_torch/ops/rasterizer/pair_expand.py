"""The pair-key expansion kernel (K1): one sort key per gaussian-tile pair.

Counterpart of ``multiview_inpaint_tpu/ops/rasterizer/pair_expand.py``
(``_kernel`` via ``expand_keys``). Input is the compacted rect table:
gaussians in depth-rank order with the ``n_active`` pair-emitting ones
(count > 0) first, and int64 ``starts`` (exclusive cumsum of the counts).
Compacted gaussian g owns pair slots ``starts[g] .. starts[g] + count[g]``
and writes its rect's tiles there in row-major order, each as the int64
key ``tile << 32 | g``. One ``torch.sort`` of the keys then orders pairs
by tile and, within a tile, by depth rank.

The CUDA source is ``csrc/pair_expand.cu``: each block owns a fixed
range of pair slots, finds the gaussians that own them by searches over
``starts`` (the kernel reads neither ``count`` nor anything past the
actives) and writes one key per thread, consecutive threads on
consecutive slots. The TPU kernel's window, bf16 split and
``expand_needed`` report have no counterpart here.
"""

from __future__ import annotations

import torch

from ... import kernels as _kernels
from ... import telemetry

KEY_SHIFT = 32  # tile id in the high word, depth rank in the low word


def expand_keys_ref(starts: torch.Tensor, x0: torch.Tensor,
                    y0: torch.Tensor, w: torch.Tensor, count: torch.Tensor,
                    n_active: int, total: int, tiles_x: int) -> torch.Tensor:
    """Plain version of K1: ``repeat_interleave`` + integer division."""
    dev = starts.device
    g = torch.repeat_interleave(torch.arange(n_active, device=dev),
                                count[:n_active], output_size=total)
    local = torch.arange(total, device=dev) - starts[g]
    wg = w[g].to(torch.int64)
    q = torch.div(local, wg, rounding_mode="floor")
    r = local - q * wg
    tile = (y0[g].to(torch.int64) + q) * tiles_x + x0[g].to(torch.int64) + r
    return (tile << KEY_SHIFT) | g


def expand_keys(starts: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                w: torch.Tensor, count: torch.Tensor, n_active: int,
                total: int, tiles_x: int) -> torch.Tensor:
    """[total] int64 unsorted pair keys. ``starts``/``count`` int64 and
    ``x0``/``y0``/``w`` int32, all [N] compacted. CPU tensors take the
    plain version; CUDA tensors launch the kernel; any other device
    raises."""
    dev = starts.device
    if dev.type == "cpu":
        return expand_keys_ref(starts, x0, y0, w, count, n_active, total,
                               tiles_x)
    if dev.type != "cuda":
        raise ValueError(f"expand_keys: unsupported device {dev}")
    n = starts.shape[0]
    for name, t, dt in (("starts", starts, torch.int64),
                        ("count", count, torch.int64),
                        ("x0", x0, torch.int32), ("y0", y0, torch.int32),
                        ("w", w, torch.int32)):
        if t.dtype != dt or t.shape != (n,) or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"{name} must be contiguous {dt} [{n}] on {dev}")
    if not 0 <= n_active <= n:
        raise ValueError(f"n_active {n_active} outside [0, {n}]")
    keys = torch.empty(total, dtype=torch.int64, device=dev)
    if n_active == 0 or total == 0:
        # A grid of zero blocks is an invalid launch; no pairs, no keys.
        return keys
    lib = _kernels.library()
    rc = lib.mvi_expand_keys(starts.data_ptr(), x0.data_ptr(),
                             y0.data_ptr(), w.data_ptr(), n_active, total,
                             tiles_x, keys.data_ptr(),
                             _kernels.stream_ptr(dev))
    _kernels.check(rc, "pair_expand")
    telemetry.count("launch.pair_expand")
    return keys
