"""Video ControlNet, the paper's control branch (PyTorch).

Counterpart of ``multiview_inpaint_tpu/diffusion/controlnet.py`` (the
reference's ``models/csvd.py`` ControlNet): a copy of the VideoUNet's
encoder and middle whose hidden states pass through zero-initialised 1x1
convs to become 13 residuals, and ``input_hint_block``, which embeds the
7-channel control hint (estimated depth 3, box mask 1, background-masked
render 3) at image resolution down to the latent grid: 7 -> 16 -> 16 ->
32 -> 32 -> 96 -> 96 -> 256 with stride 2 at the channel jumps, then a
zero conv to the model width.

The trunk's parameters sit at the top level (``input_blocks.*``,
``middle_block.*``, ``time_embed.*``, ``label_emb.*``) beside
``input_hint_block.*``, ``zero_convs.*`` and ``middle_block_out.*``: the
reference's ``control_model.`` key space. This module is therefore a
VideoUNet built without its decoder.
"""

from __future__ import annotations

from typing import List

from torch import nn

from .layers import zero_
from .unet import UNetConfig, VideoUNet

HINT_CHANNELS = (16, 16, 32, 32, 96, 96, 256)
HINT_STRIDES = (1, 1, 2, 1, 2, 1, 2)


class ControlNet(VideoUNet):
    def __init__(self, cfg: UNetConfig = UNetConfig(), hint_channels: int = 7,
                 **factory):
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

    def forward(self, x, hint, timesteps, context=None, y=None,
                num_video_frames: int = 1,
                image_only_indicator=None) -> List:
        """x [(b t), h, w, C_in] and hint [(b t), H, W, C_hint] (NHWC);
        returns the 13 NHWC residuals, the middle one last."""
        guided = self.input_hint_block(hint.permute(0, 3, 1, 2))
        feats = super().forward(
            x, timesteps, context=context, y=y,
            num_video_frames=num_video_frames,
            image_only_indicator=image_only_indicator, extract_features=True,
            hint=guided.permute(0, 2, 3, 1))
        outs = [zc(f.permute(0, 3, 1, 2))
                for f, zc in zip(feats[:-1], self.zero_convs)]
        outs.append(self.middle_block_out(feats[-1].permute(0, 3, 1, 2)))
        return [o.permute(0, 2, 3, 1) for o in outs]
