"""Plain pair keys: one int64 ``tile << 32 | rank`` per gaussian-tile pair
(the port's plain ``pair_expand.expand_keys_ref``)."""

from __future__ import annotations

import torch

KEY_SHIFT = 32


def expand_keys(starts, x0, y0, w, count, n_active: int, total: int,
                tiles_x: int) -> torch.Tensor:
    dev = starts.device
    g = torch.repeat_interleave(torch.arange(n_active, device=dev),
                                count[:n_active], output_size=total)
    local = torch.arange(total, device=dev) - starts[g]
    wg = w[g].to(torch.int64)
    q = torch.div(local, wg, rounding_mode="floor")
    r = local - q * wg
    tile = (y0[g].to(torch.int64) + q) * tiles_x + x0[g].to(torch.int64) + r
    return (tile << KEY_SHIFT) | g
