"""The original TrackNet (Huang et al., AVSS 2019) served plainly: the
published ``BallTrackerNet`` (github.com/yastrebksv/TrackNet, ``model.py``)
in float32 from a state dict, its window inputs, the gray map and the rows
of one clip.

The network: 18 blocks, each ``Conv3x3(pad 1, bias) -> ReLU -> BatchNorm``
(running statistics, eps 1e-5), widths 64, 64 | pool | 128, 128 | pool |
256 x3 | pool | 512 x3 | up | 256 x3 | up | 128 x2 | up | 64 x2, 256; 2x2
max pools, nearest 2x upsamples, no skips. The last block's 256 channels
are class logits per pixel; the gray map is their argmax (the first class
on ties) and the ball is read from ``gray > 127``.

A window is frames t, t-1, t-2 (the current one first), each BGR, stacked
to 9 channels and divided by 255 in float32, as ``BallTrackerNet``'s
dataset stacks ``cv2.imread`` frames; it gives the map of frame t, so
windows slide by one frame and frames 0 and 1 are invisible. Frames come as
YUV420 and become RGB as ``reference.serve.yuv420_to_rgb`` has it; rows are
scaled to the source as there.

Departures from the published inference: it finds the ball with
``cv2.HoughCircles`` on the binary map, and no cv2 is at hand here, so the
ball is the peak blob of ``reference.serve.decode`` on ``gray / 255``
(threshold 0.5, which is ``gray > 127``), the rule the program serves with.

Windows go through the network in blocks of ``BLOCK``, so a clip of 1,600
frames at 360x640 needs no more than one block's activations at a time.
``quant`` (``reference.tracknet.FP8``) rounds each conv's input and weight
to float8 e4m3: the control of the bfloat16 program.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .serve import decode, yuv420_to_rgb
from .tracknet import EPS, Quant, plain_math

SEQ_LEN = 3
BLOCK = 16  # windows forwarded at once
# (out channels, what follows the block), blocks 1..18
LAYERS = ((64, ""), (64, "pool"), (128, ""), (128, "pool"), (256, ""), (256, ""), (256, "pool"),
          (512, ""), (512, ""), (512, "up"), (256, ""), (256, ""), (256, "up"), (128, ""),
          (128, "up"), (64, ""), (64, ""), (256, ""))


class ConvBlock(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.block = nn.Sequential(nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=True),
                                   nn.ReLU(), nn.BatchNorm2d(out_channels))

    def forward(self, x):
        return self.block(x)


class BallTrackerNet(nn.Module):
    """The published module, for the state dicts it writes: ``conv{i}`` and
    ``forward`` returning ``(N, 256, H * W)`` as it does."""

    def __init__(self, out_channels: int = 256):
        super().__init__()
        prev = 3 * SEQ_LEN
        for i, (co, _) in enumerate(LAYERS):
            co = out_channels if i == len(LAYERS) - 1 else co
            self.add_module(f"conv{i + 1}", ConvBlock(prev, co))
            prev = co

    def forward(self, x):
        for i, (_, after) in enumerate(LAYERS):
            x = getattr(self, f"conv{i + 1}")(x)
            if after == "pool":
                x = F.max_pool2d(x, 2)
            elif after == "up":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
        return x.reshape(x.shape[0], x.shape[1], -1)


def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return quant.fwd(x) if quant is not None else x


def logits(sd: Dict[str, torch.Tensor], x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """(N, 9, H, W) float32 windows -> (N, 256, H, W) class logits, from a
    ``BallTrackerNet`` state dict (BatchNorm on its running statistics)."""
    for i, (_, after) in enumerate(LAYERS):
        pre = f"conv{i + 1}.block."
        y = F.conv2d(_q(x, quant), _q(sd[pre + "0.weight"], quant), sd[pre + "0.bias"],
                     padding=1)
        y = torch.relu(y)
        mean, var = sd[pre + "2.running_mean"], sd[pre + "2.running_var"]
        x = ((y - mean[None, :, None, None]) / torch.sqrt(var + EPS)[None, :, None, None]
             * sd[pre + "2.weight"][None, :, None, None] + sd[pre + "2.bias"][None, :, None, None])
        if after == "pool":
            x = F.max_pool2d(x, 2)
        elif after == "up":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
    return x


def window_inputs(rgb: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """(n, 9, h, w) float32 inputs of the windows starting at ``starts``
    (frames s .. s + 2, the window of frame t = s + 2): frames t, t-1, t-2,
    each BGR, / 255."""
    T, h, w = rgb.shape[:3]
    idx = (starts[:, None] + torch.arange(SEQ_LEN - 1, -1, -1, device=rgb.device)[None, :])
    x = rgb[idx.clamp(max=T - 1)].flip(-1).to(torch.float32) / 255.0  # (n, 3, h, w, 3) BGR
    return x.permute(0, 1, 4, 2, 3).reshape(len(starts), 3 * SEQ_LEN, h, w)


def gray(class_logits: torch.Tensor) -> torch.Tensor:
    """(n, 256, h, w) logits -> (n, h, w) uint8 gray levels."""
    return class_logits.argmax(dim=1).to(torch.uint8)


def clip_rows(yuv: torch.Tensor, model: Dict, src_wh, sd: Dict[str, torch.Tensor],
              quant: Quant = None, on_block: Optional[Callable] = None) -> Dict[str, np.ndarray]:
    """The served rows (X, Y, Visibility) of one clip's (T, h*w*3/2) YUV420
    frames on the reference's device, TF32 off. ``on_block(starts,
    logits)`` sees each block's window starts and (n, 256, h, w) logits."""
    h, w = int(model["height"]), int(model["width"])
    rgb = yuv420_to_rgb(yuv, h, w)
    T = rgb.shape[0]
    S = max(T - SEQ_LEN + 1, 0)
    cx = np.zeros(T, np.int64)
    cy = np.zeros(T, np.int64)
    with plain_math(), torch.no_grad():
        for b0 in range(0, S, BLOCK):
            st = torch.arange(b0, min(b0 + BLOCK, S), device=yuv.device)
            out = logits(sd, window_inputs(rgb, st), quant)
            if on_block is not None:
                on_block(st, out)
            g = gray(out)
            del out
            bx, by = decode(g.to(torch.float32) / 255.0)
            cx[b0 + SEQ_LEN - 1:b0 + SEQ_LEN - 1 + len(st)] = bx
            cy[b0 + SEQ_LEN - 1:b0 + SEQ_LEN - 1 + len(st)] = by
    src_w, src_h = src_wh
    return {"X": (cx * (src_w / w)).astype(np.int64), "Y": (cy * (src_h / h)).astype(np.int64),
            "Visibility": ((cx != 0) | (cy != 0)).astype(np.int64)}
