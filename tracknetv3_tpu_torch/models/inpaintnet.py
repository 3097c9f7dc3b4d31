"""InpaintNet: 1-D conv encoder-decoder for trajectory gap repair (port).

Same network as the JAX package's ``models/inpaintnet.py``: input (N, L, 2)
normalised coordinates and an (N, L, 1) inpaint mask, concatenated to
(N, L, 3); Conv1d k=3 'same' (padding 1) with bias + LeakyReLU 0.01 at
widths 32, 64, 128 (down_1..3), 256, 256 (bottleneck_1..2); the decoder
concatenates ``[x, skip]`` (x3, x2, x1) before up_1..3 (128, 64, 32); a
Conv1d(32 -> 2, k=3) head and a float32 sigmoid. Parameter names
(``down_1.conv.weight``, ...) follow the flax module's paths.

The network computes in its parameters' dtype: float32 as built, as in the
JAX package (the parity tests take float64 with ``.double()``); callers on
the card run it with TF32 off (``device.tf32_off``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv1DBlock(nn.Module):
    """Conv1d k=3 'same' with bias + LeakyReLU(0.01)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.conv(x), negative_slope=0.01)


class InpaintNet(nn.Module):
    """Trajectory inpainting network: (N, L, 2) coords + (N, L, 1) mask ->
    (N, L, 2) coordinates in [0, 1] in the parameters' dtype."""

    def __init__(self):
        super().__init__()
        self.down_1 = Conv1DBlock(3, 32)
        self.down_2 = Conv1DBlock(32, 64)
        self.down_3 = Conv1DBlock(64, 128)
        self.bottleneck_1 = Conv1DBlock(128, 256)
        self.bottleneck_2 = Conv1DBlock(256, 256)
        self.up_1 = Conv1DBlock(384, 128)
        self.up_2 = Conv1DBlock(192, 64)
        self.up_3 = Conv1DBlock(96, 32)
        self.predictor = nn.Conv1d(32, 2, 3, padding=1)

    def forward(self, coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dtype = self.predictor.weight.dtype
        x = torch.cat([coords, mask], dim=-1).to(dtype).transpose(1, 2)  # (N, 3, L)
        x1 = self.down_1(x)
        x2 = self.down_2(x1)
        x3 = self.down_3(x2)
        x = self.bottleneck_2(self.bottleneck_1(x3))
        x = self.up_1(torch.cat([x, x3], dim=1))
        x = self.up_2(torch.cat([x, x2], dim=1))
        x = self.up_3(torch.cat([x, x1], dim=1))
        return torch.sigmoid(self.predictor(x)).transpose(1, 2)  # (N, L, 2)
