"""2D ControlNet (depth-conditioned) of the candidate-inpainting stage
(PyTorch).

Counterpart of ``multiview_inpaint_tpu/diffusion/controlnet2d.py`` (the
reference ``ctrl_inpaint.py`` drives HF's SD-inpainting UNet with a depth
ControlNet): a copy of ``UNet2D``'s encoder and middle (the trunk), the
16 -> 16 -> 32 -> 32 -> 96 -> 96 -> 256 hint stack on a 3-channel depth
hint with stride 2 and explicit padding 1 at the channel jumps, a zero
conv to the model width added after the trunk's input conv, and zero 1x1
convs that turn each hidden state into a residual.

The trunk's parameters sit at the top level (``input_blocks.*``,
``middle_block.*``, ``time_embed.*``) beside ``input_hint_block.*``,
``zero_convs.*`` and ``middle_block_out.*``: the reference's
``control_model.`` key space, with the trunk's ResBlock parameters at
block level as in ``UNet2D``. (The JAX ``weights_io.import_controlnet``
maps the trunk through the video key space, where those parameters gain a
``spatial`` level, and so leaves them at their init; the port loads them.)
"""

from __future__ import annotations

from typing import List

from torch import nn

from .controlnet import HINT_CHANNELS, HINT_STRIDES
from .layers import zero_
from .unet2d import UNet2D, UNet2DConfig


class ControlNet2D(UNet2D):
    def __init__(self, cfg: UNet2DConfig = UNet2DConfig(),
                 hint_channels: int = 3, **factory):
        super().__init__(cfg, encoder_only=True, **factory)
        layers, cin = [], hint_channels
        for cout, s in zip(HINT_CHANNELS, HINT_STRIDES):
            layers += [nn.Conv2d(cin, cout, 3, stride=s, padding=1,
                                 **factory), nn.SiLU()]
            cin = cout
        layers.append(zero_(nn.Conv2d(cin, cfg.model_channels, 3, padding=1,
                                      **factory)))
        self.input_hint_block = nn.Sequential(*layers)
        self.zero_convs = nn.ModuleList(
            nn.Sequential(zero_(nn.Conv2d(c, c, 1, **factory)))
            for c in self.feature_channels[:-1])
        c = self.feature_channels[-1]
        self.middle_block_out = nn.Sequential(
            zero_(nn.Conv2d(c, c, 1, **factory)))

    def forward(self, x, hint, timesteps, context=None) -> List:
        """x [B, h, w, C_in] and hint [B, H, W, C_hint] (NHWC); returns
        the NHWC residuals, the middle one last."""
        guided = self.input_hint_block(hint.permute(0, 3, 1, 2))
        feats = super().forward(x, timesteps, context=context,
                                extract_features=True,
                                hint=guided.permute(0, 2, 3, 1))
        outs = [zc(f.permute(0, 3, 1, 2))
                for f, zc in zip(feats[:-1], self.zero_convs)]
        outs.append(self.middle_block_out(feats[-1].permute(0, 3, 1, 2)))
        return [o.permute(0, 2, 3, 1) for o in outs]
