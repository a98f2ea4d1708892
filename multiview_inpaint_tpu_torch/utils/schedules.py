"""Learning-rate schedules and small numeric helpers.

Port of ``multiview_inpaint_tpu/utils/schedules.py`` (reference
``gs-simp/utils/general_utils.py:31-78``): log-lerp exponential decay with
an optional delayed sine warm ramp, and the inverse sigmoid.
"""

from __future__ import annotations

import math

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


def expon_lr(step, lr_init: float, lr_final: float, max_steps: int,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0
             ) -> torch.Tensor:
    """Log-linearly interpolated LR with optional delayed start, as a
    float32 tensor. Returns 0 when lr_init == lr_final == 0 (disabled
    group) and for negative steps (reference convention)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        pct = torch.clamp(step / lr_delay_steps, 0.0, 1.0)
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * pct)
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(torch.tensor(lr_init, dtype=torch.float32))
                         * (1 - t)
                         + torch.log(torch.tensor(lr_final,
                                                  dtype=torch.float32)) * t)
    return torch.where(step >= 0, delay_rate * log_lerp,
                       torch.zeros_like(log_lerp))
