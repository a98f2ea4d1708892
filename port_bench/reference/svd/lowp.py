"""The control's arithmetic: float8 (e4m3) emulation of a network's
matrix products.

``emulate_fp8(module)`` hooks every linear and convolution layer of
``module``: each call computes with its weight rounded to float8 e4m3
under one scale per output channel, and its input rounded to e4m3 under
one scale per tensor; the products themselves run in the module's type.
Gradients pass the rounding unchanged (a straight-through estimate), so
a training step through the control computes every gradient. This is
the step below the bfloat16 the configuration states, the one a later
change could be tempted to take.
"""

from __future__ import annotations

import torch
from torch import nn

E4M3_MAX = 448.0
LAYERS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def round_e4m3(x: torch.Tensor, dims=None) -> torch.Tensor:
    """x rounded to e4m3 under the scale that maps its largest magnitude
    (over ``dims``, or the whole tensor) to e4m3's largest value; the
    gradient passes through unchanged."""
    with torch.no_grad():
        amax = (x.abs().amax() if dims is None
                else x.abs().amax(dim=dims, keepdim=True)).float()
        scale = torch.where(amax > 0, E4M3_MAX / amax,
                            torch.ones_like(amax))
        q = ((x.float() * scale).to(torch.float8_e4m3fn).float()
             / scale).to(x.dtype)
    return x + (q - x).detach()


def _before(module, args):
    w = module.weight
    module._unrounded = w.data
    w.data = round_e4m3(w.data, tuple(range(1, w.dim())))
    return (round_e4m3(args[0]),) + tuple(args[1:])


def _after(module, args, out):
    module.weight.data = module._unrounded
    del module._unrounded


def emulate_fp8(module: nn.Module) -> nn.Module:
    for m in module.modules():
        if isinstance(m, LAYERS):
            m.register_forward_pre_hook(_before)
            m.register_forward_hook(_after)
    return module
