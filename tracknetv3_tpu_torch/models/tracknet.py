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

``forward_shares`` is the train forward over a list of shares of one
global batch (the mesh entries of this process; the train step runs it
over one share on one device too), layer by layer: each share's conv on
its entry with that entry's copy of the weights, each BatchNorm
synchronised over every share (``ops.batchnorm.sync_bn_relu_train``
through a ``parallel.mesh.Reducer``; the unsplit op where one share of one
process is the whole batch), pool, upsample and concat per share.
``forward`` is the same U-Net over one share with the module's own
parameters, in train or eval mode.
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

    def forward_shares(self, xs, params, prefix: str, dtype: torch.dtype, reducer):
        """Train mode over shares: share w's conv with ``params[w]`` (names
        under ``prefix``), then the BatchNorm over all shares; the running
        statistics are the module's."""
        ys = [F.conv2d(x.to(dtype), p[prefix + "conv.weight"].to(dtype), padding=1)
              for x, p in zip(xs, params)]
        bn = self.bn
        return batchnorm.sync_bn_relu_train(
            ys, [p[prefix + "bn.weight"] for p in params], [p[prefix + "bn.bias"] for p in params],
            bn.running_mean, bn.running_var, reducer)


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

    def forward_shares(self, xs, params, prefix: str, dtype: torch.dtype, reducer):
        for name, layer in self.named_children():
            xs = layer.forward_shares(xs, params, f"{prefix}{name}.", dtype, reducer)
        return xs


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
        own = {"predictor.weight": self.predictor.weight, "predictor.bias": self.predictor.bias}
        return self._unet([x], [own], lambda name, xs: [getattr(self, name)(xs[0], self.dtype)])[0]

    def forward_shares(self, xs, params, reducer) -> list:
        """Train-mode logits of each share ``xs[w]`` with the parameters
        ``params[w]`` (by name, on the share's device), every BatchNorm
        synchronised through ``reducer`` and updating this module's running
        statistics once."""
        return self._unet(xs, params, lambda name, xs: getattr(self, name).forward_shares(
            xs, params, name + ".", self.dtype, reducer))

    def _unet(self, xs, params, stack):
        """The U-Net over the shares ``xs``; ``stack(name, xs)`` applies the
        conv stack ``name`` to every share."""
        dt = self.dtype
        pool = lambda ts: [F.max_pool2d(t, 2) for t in ts]  # noqa: E731
        up_cat = lambda ts, skips: [torch.cat([upsample2x_nearest(t), s], dim=1)  # noqa: E731
                                    for t, s in zip(ts, skips)]
        x1 = stack("down_block_1", xs)
        x2 = stack("down_block_2", pool(x1))
        x3 = stack("down_block_3", pool(x2))
        x = stack("bottleneck", pool(x3))
        x = stack("up_block_1", up_cat(x, x3))
        x = stack("up_block_2", up_cat(x, x2))
        x = stack("up_block_3", up_cat(x, x1))
        out = []
        for t, p in zip(x, params):
            logits = F.conv2d(t, p["predictor.weight"].to(dt))
            logits = logits.to(torch.promote_types(dt, torch.float32))
            out.append((logits + p["predictor.bias"][:, None, None]).contiguous())
        return out
