"""Light-curve embedding network: a 1-D convolutional ResNet, channels first.

Port of ``nmma_tpu/mlmodel/embedding.py`` (after the reference's
nmma/mlmodel/resnet.py:228-468 and embedding.py:17-178). Light curves
[B, F, T] are already channels first: the filters are the input channels.
flax's ``SAME`` padding at kernel 3 is padding 1, its ``avg_pool`` is VALID.
"""

from __future__ import annotations

import torch
from torch import nn

from .flows import lecun_init


class ResBlock1D(nn.Module):
    """conv3 -> relu -> conv3, plus the input (through a 1x1 conv where the
    width changes) -> relu (flax Conv_0, Conv_1, Conv_2)."""

    def __init__(self, in_channels, channels):
        super().__init__()
        self.conv0 = nn.Conv1d(in_channels, channels, 3, padding=1)
        self.conv1 = nn.Conv1d(channels, channels, 3, padding=1)
        self.proj = (nn.Conv1d(in_channels, channels, 1)
                     if in_channels != channels else None)

    def forward(self, x):
        h = self.conv1(torch.relu(self.conv0(x)))
        if self.proj is not None:
            x = self.proj(x)
        return torch.relu(x + h)


class LightCurveEmbedding(nn.Module):
    """[B, F, T] magnitudes -> [B, embed_dim]: brightness standardised as
    (mag_ref - mag) / mag_scale, non-finite entries set to
    ``invalid_value``, three residual blocks with two average pools, the
    mean over time and two dense layers."""

    def __init__(self, n_filters, embed_dim=20, channels=32, mag_ref=25.0,
                 mag_scale=5.0, invalid_value=-3.0):
        super().__init__()
        self.mag_ref, self.mag_scale = mag_ref, mag_scale
        self.invalid_value = invalid_value
        self.blocks = nn.ModuleList([ResBlock1D(n_filters, channels),
                                     ResBlock1D(channels, channels),
                                     ResBlock1D(channels, channels)])
        self.dense0 = nn.Linear(channels, 64)
        self.dense1 = nn.Linear(64, embed_dim)
        lecun_init(self)

    def forward(self, lc):
        finite = torch.isfinite(lc)
        x = torch.where(finite, (self.mag_ref - torch.where(finite, lc, 0.0))
                        / self.mag_scale, self.invalid_value)
        x = self.blocks[0](x)
        x = nn.functional.avg_pool1d(x, 2, 2)
        x = self.blocks[1](x)
        x = nn.functional.avg_pool1d(x, 2, 2)
        x = self.blocks[2](x).mean(-1)          # global average over time
        return self.dense1(torch.relu(self.dense0(x)))
