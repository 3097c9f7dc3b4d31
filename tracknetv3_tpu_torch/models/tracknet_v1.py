"""TrackNetV1: the original TrackNet (Huang et al., AVSS 2019), a VGG-16
encoder-decoder that classifies every pixel into 256 gray levels.

Architecture (``BallTrackerNet`` of github.com/yastrebksv/TrackNet,
``model.py``): 18 blocks, each ``Conv3x3(pad 1, bias) -> ReLU ->
BatchNorm`` (eps 1e-5), widths 64, 64 | pool | 128, 128 | pool | 256 x3 |
pool | 512 x3 | up | 256 x3 | up | 128 x2 | up | 64 x2, then 64 -> 256;
2x2 max pools, nearest 2x upsamples, no skip connections. The last block's
256 channels are class logits per pixel: the gray map is their argmax
(0..255), and serving reads the ball from ``gray > 127``.

Input: frames t, t-1, t-2 (the current one first), each BGR / 255,
stacked to 9 channels, at 360x640. One window gives the map of frame t,
so windows slide by one frame and frames 0 and 1 get no prediction.

Parameter names follow the published state dict (``conv{i}.block.0.*`` the
conv, ``conv{i}.block.2.*`` the BatchNorm), so ``load_state_dict`` takes a
``BallTrackerNet`` state dict as it is. ``forward`` is the float32 module
(BatchNorm on its running statistics in eval mode, on the batch's in train
mode) and returns NCHW logits ``(N, 256, H, W)``, where ``BallTrackerNet``
returns them flattened to ``(N, 256, H * W)``. Serving runs the folded
forward of ``models/fused_forward.py`` (``tracknet_v1_fused_forward``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

ARCH = "TrackNetV1"  # the checkpoint's param_dict["model_name"]
SEQ_LEN = 3  # frames a window holds
IN_CHANNELS = 3 * SEQ_LEN
OUT_CHANNELS = 256  # gray levels
HEIGHT, WIDTH = 360, 640  # the published input resolution
EPS = 1e-5
# (out channels, what follows the block: "" / "pool" / "up"), blocks 1..18
LAYERS: Tuple[Tuple[int, str], ...] = (
    (64, ""), (64, "pool"), (128, ""), (128, "pool"), (256, ""), (256, ""), (256, "pool"),
    (512, ""), (512, ""), (512, "up"), (256, ""), (256, ""), (256, "up"), (128, ""),
    (128, "up"), (64, ""), (64, ""), (OUT_CHANNELS, ""))


def layer_channels(in_channels: int = IN_CHANNELS) -> List[Tuple[int, int, str]]:
    """(in channels, out channels, what follows) of the 18 blocks."""
    out, prev = [], in_channels
    for co, after in LAYERS:
        out.append((prev, co, after))
        prev = co
    return out


class ConvBlock(nn.Module):
    """``Conv2d(3x3, pad 1, bias) -> ReLU -> BatchNorm2d`` as ``block``, the
    published module's names."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.block = nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=True),
                                   nn.ReLU(), nn.BatchNorm2d(out_ch, eps=EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class TrackNetV1(nn.Module):
    """``(N, 9, H, W)`` windows in [0, 1] -> ``(N, 256, H, W)`` class logits;
    H and W multiples of 8."""

    def __init__(self, in_dim: int = IN_CHANNELS, out_dim: int = OUT_CHANNELS):
        super().__init__()
        for i, (ci, co, _) in enumerate(layer_channels(in_dim)):
            self.add_module(f"conv{i + 1}", ConvBlock(ci, out_dim if i == len(LAYERS) - 1 else co))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (_, _, after) in enumerate(layer_channels(x.shape[1])):
            x = getattr(self, f"conv{i + 1}")(x)
            if after == "pool":
                x = nn.functional.max_pool2d(x, 2)
            elif after == "up":
                x = nn.functional.interpolate(x, scale_factor=2, mode="nearest")
        return x


def blocks(model_or_state) -> List[Tuple[torch.Tensor, ...]]:
    """Each block's (conv weight OIHW, conv bias, BatchNorm weight, bias,
    running mean, running var), float32 on the CPU, from a ``TrackNetV1`` or
    its state dict."""
    sd = model_or_state.state_dict() if isinstance(model_or_state, nn.Module) else model_or_state
    out = []
    for i in range(len(LAYERS)):
        pre = f"conv{i + 1}.block."
        out.append(tuple(sd[pre + k].detach().float().cpu() for k in (
            "0.weight", "0.bias", "2.weight", "2.bias", "2.running_mean", "2.running_var")))
    return out
