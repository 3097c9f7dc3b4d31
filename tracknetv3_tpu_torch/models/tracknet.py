"""TrackNet: VGG-style U-Net heatmap regressor (PyTorch port).

Architecture (reference model.py:44-73): encoder Double(in->64) -> pool ->
Double(64->128) -> pool -> Triple(128->256) -> pool -> Triple(256->512)
bottleneck; decoder 3x [nearest-2x upsample -> concat [up, skip] -> conv
block] (768->256, 384->128, 192->64); 1x1 predictor to ``out_dim``
channels. Each conv block is a 3x3 padding-1 conv without bias, BatchNorm
and ReLU. Parameter names (``down_block_1.conv_1.conv.weight``, ...) follow
the reference's state dict.

Numerics follow the JAX package's training forward
(``tracknetv3_tpu/models/fused_forward.py::tracknet_train_forward``), not
``nn.BatchNorm2d``:

- the conv runs in the working dtype (input and kernel cast to it) and its
  output stays in the working dtype;
- BatchNorm + ReLU is one op, ``ops.batchnorm.bn_relu_train`` (train
  mode) or ``bn_relu_eval`` (running statistics): hand-written CUDA
  kernels on the card, their plain versions on the CPU. Statistics over
  (N, H, W) as ``E[y^2] - E[y]^2`` clamped at 0, normalisation
  ``(y - mean) / sqrt(var + eps) * scale + bias`` in float32 (float64 for
  a float64 working dtype, as the JAX forward's ``stats_dtype``), a running
  update ``0.9 * old + 0.1 * batch`` with the *biased* batch variance, the
  ReLU output cast back to the working dtype, and ``jnp.maximum``'s
  gradient (half at a tie);
- the predictor's 1x1 conv runs in the working dtype, its output is cast to
  float32 and then the float32 bias is added.

The forward returns float32 (float64 for a float64 working dtype) logits
in contiguous NCHW ``(B, L, H, W)`` whatever the input's memory format,
so the loss kernel reads them without a copy. On the card the input must
be channels_last (the BatchNorm kernels take no other layout).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import batchnorm


class BatchNorm(nn.Module):
    """The parameters and running statistics of one BatchNorm (the JAX
    package's ``bn`` scope); ``ConvBNRelu`` applies them with ReLU."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))


class ConvBNRelu(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.conv2d(x.to(dtype), self.conv.weight.to(dtype), padding=1)
        bn = self.bn
        op = batchnorm.bn_relu_train if self.training else batchnorm.bn_relu_eval
        return op(y, bn.weight, bn.bias, bn.running_mean, bn.running_var)


class ConvStack(nn.Module):
    """``num_blocks`` ConvBNRelu layers named ``conv_1`` ... ``conv_n``."""

    def __init__(self, in_ch: int, out_ch: int, num_blocks: int):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(f"conv_{i + 1}", ConvBNRelu(in_ch if i == 0 else out_ch, out_ch))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for layer in self.children():
            x = layer(x, dtype)
        return x


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of NCHW (torch ``nn.Upsample(scale_factor=2)``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class TrackNet(nn.Module):
    """U-Net over channel-stacked frame windows.

    Input ``(N, C_in, H, W)`` with ``C_in = tracknet_in_channels(...)``;
    output float32 logits ``(N, out_dim, H, W)``, one channel per frame.
    ``dtype`` is the working dtype of the convolutions (bfloat16 on the
    card, float32 for parity tests); parameters stay float32.
    """

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.down_block_1 = ConvStack(in_dim, 64, 2)
        self.down_block_2 = ConvStack(64, 128, 2)
        self.down_block_3 = ConvStack(128, 256, 3)
        self.bottleneck = ConvStack(256, 512, 3)
        self.up_block_1 = ConvStack(768, 256, 3)
        self.up_block_2 = ConvStack(384, 128, 2)
        self.up_block_3 = ConvStack(192, 64, 2)
        self.predictor = nn.Conv2d(64, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x1 = self.down_block_1(x, dt)
        x2 = self.down_block_2(F.max_pool2d(x1, 2), dt)
        x3 = self.down_block_3(F.max_pool2d(x2, 2), dt)
        x = self.bottleneck(F.max_pool2d(x3, 2), dt)
        x = self.up_block_1(torch.cat([upsample2x_nearest(x), x3], dim=1), dt)
        x = self.up_block_2(torch.cat([upsample2x_nearest(x), x2], dim=1), dt)
        x = self.up_block_3(torch.cat([upsample2x_nearest(x), x1], dim=1), dt)
        logits = F.conv2d(x, self.predictor.weight.to(dt))
        logits = logits.to(torch.promote_types(dt, torch.float32))
        logits = logits + self.predictor.bias[:, None, None]
        return logits.contiguous()
