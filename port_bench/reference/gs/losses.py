"""Photometric losses: L1/L2, windowed SSIM, PSNR.

Port of ``multiview_inpaint_tpu/utils/losses.py`` (reference
``gs-simp/utils/loss_utils.py:17-64``, ``utils/image_utils.py:14-17``):
11x11 gaussian window with sigma 1.5, per-channel separable same-padded
blur, C1 = 0.01^2 and C2 = 0.03^2.

SSIM subtracts blurred second moments (E[x^2] - mu^2) and compares them
with C2 = 9e-4. A float32 convolution on CUDA runs through cuDNN in TF32
by default (``torch.backends.cudnn.allow_tf32`` is True, ~5e-4 relative
error), which is the same loss of precision that drove the reference's
training loss negative on the TPU (its ``_sep_blur`` note). So the blur
is an autograd function whose forward and backward both switch TF32 off
for their own convolutions, whatever the global switch says.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - y))


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2, dim=(-3, -2, -1), keepdim=True)


def psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 20 * torch.log10(1.0 / torch.sqrt(mse(x, y)))


def _gaussian_window(size: int, sigma: float, device=None) -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


@contextlib.contextmanager
def _fp32_convs():
    """cuDNN convolutions in true float32 inside the block; the caller's
    setting is restored after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    c = img.shape[0]
    size = window.shape[0]
    pad = size // 2
    x = img[None]                                         # [1, C, H, W]
    wr = window.reshape(1, 1, size, 1).repeat(c, 1, 1, 1)
    wc = window.reshape(1, 1, 1, size).repeat(c, 1, 1, 1)
    with _fp32_convs():
        x = F.conv2d(x, wr, padding=(pad, 0), groups=c)
        x = F.conv2d(x, wc, padding=(0, pad), groups=c)
    return x[0]


class _SepBlur(torch.autograd.Function):
    """Separable same-padded blur with a symmetric window. It is its own
    adjoint (zero padding, symmetric taps), so the backward is the same
    blur of the cotangent, also in float32."""

    @staticmethod
    def forward(ctx, img, window):
        ctx.save_for_backward(window)
        return _blur(img, window)

    @staticmethod
    def backward(ctx, grad):
        (window,) = ctx.saved_tensors
        return _blur(grad.contiguous(), window), None


def _sep_blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable same-padded gaussian blur of [C, H, W] in float32."""
    return _SepBlur.apply(img, window)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two [C, H, W] images in [0, 1]."""
    window = _gaussian_window(window_size, 1.5, img1.device)
    c = img1.shape[0]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                        dim=0)
    blurred = _sep_blur(stacked, window)
    mu1, mu2 = blurred[0:c], blurred[c:2 * c]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blurred[2 * c:3 * c] - mu1_sq
    sigma2_sq = blurred[3 * c:4 * c] - mu2_sq
    sigma12 = blurred[4 * c:5 * c] - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                     lambda_dssim: float = 0.2) -> torch.Tensor:
    """The reference GS training objective: (1-l)*L1 + l*(1-SSIM)."""
    return ((1.0 - lambda_dssim) * l1_loss(pred, gt)
            + lambda_dssim * (1.0 - ssim(pred, gt)))
