"""Least time of a whole render or train step of the splat spine at the
chip's peaks, for ``mfu.frame`` and ``mfu.gs_step``.

A frame: every splat's 59 parameters read once, the frame (rgb, depth)
written once, and K1 and K2 as ``composite`` bounds them on the frame's
own pair lists. A train step adds: the target read once, every
parameter, gradient and both Adam moments read and written once (8 x 59
floats a splat: parameters read and written, the gradient written by the
backward and read by Adam, each moment read and written), and K3 as
``composite`` bounds it.
"""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_S

FLOATS_PER_SPLAT = 59   # xyz 3, SH 48 (degree 3), opacity 1, scale 3, rot 4


def frame_bound_s(n_splats, pixels, k1_s, k2_s) -> float:
    io = (n_splats * FLOATS_PER_SPLAT * 4 + pixels * 4 * 4) \
        / HBM_BYTES_PER_S
    return io + k1_s + k2_s


def step_bound_s(n_splats, pixels, k1_s, k2_s, k3_s) -> float:
    io = (n_splats * FLOATS_PER_SPLAT * 4 * 8 + pixels * 3 * 4 * 2) \
        / HBM_BYTES_PER_S
    return io + k1_s + k2_s + k3_s
