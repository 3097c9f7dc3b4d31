"""TrackNet and InpaintNet in plain PyTorch, float32, with no kernel, cache
or batching of the program.

TrackNet (published ``model.py``): a VGG-style U-Net; each 3x3 conv has no
bias and is followed by BatchNorm and ReLU; encoder blocks of 2, 2, 3 convs
(64, 128, 256) with 2x2 max pools, a bottleneck of 3 (512), decoder blocks
of 3, 2, 2 (256, 128, 64) after a nearest 2x upsample and a concat with the
skip ``[up, skip]``, and a 1x1 predictor to one logit map per frame.
BatchNorm uses the running statistics (``train=False``) or the batch's,
biased (``train=True``). InpaintNet: 1-D convs (k = 3, 'same') with bias
and LeakyReLU 0.01 at widths 32, 64, 128, 256, 256, a decoder over
``[x, skip]`` (128, 64, 32) and a sigmoid head of 2.

``quant`` stands for a lower precision, the control of a bfloat16
configuration: ``FP8`` rounds each conv's input and weight to float8 e4m3
and, in a backward pass, the gradient at each conv's output to float8
e5m2 (the usual pair for training in fp8), each under a per-tensor scale
that maps its largest magnitude to the format's largest value.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

BLOCKS = (("down_block_1", 2), ("down_block_2", 2), ("down_block_3", 3), ("bottleneck", 3),
          ("up_block_1", 3), ("up_block_2", 2), ("up_block_3", 2))
EPS = 1e-5


class Precision(NamedTuple):
    fwd: Callable[[torch.Tensor], torch.Tensor]  # a conv's input and weight
    bwd: Callable[[torch.Tensor], torch.Tensor]  # the gradient at a conv's output


Quant = Optional[Precision]


@contextlib.contextmanager
def plain_math(tf32: bool = False):
    """TF32 off (or on, for a control) in cuDNN and cuBLAS, and no cuDNN
    autotuning; the flags are given back after."""
    b = torch.backends
    flags = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = tf32
    b.cudnn.benchmark = False
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark = flags


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (per-tensor scale); gradients pass
    straight through."""
    return x + (_rounded(x.detach(), torch.float8_e4m3fn) - x.detach())


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, torch.float8_e5m2)


def fp8_e5m2_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is; its gradient rounded to float8 e5m2 (per-tensor
    scale)."""
    return _RoundGrad.apply(x)


FP8 = Precision(fp8_e4m3, fp8_e5m2_grad)


def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return quant.fwd(x) if quant is not None else x


def _qg(y: torch.Tensor, quant: Quant) -> torch.Tensor:
    return quant.bwd(y) if quant is not None and y.requires_grad else y


def _conv_bn_relu(x, sd: Dict[str, torch.Tensor], prefix: str, train: bool, quant: Quant):
    y = _qg(F.conv2d(_q(x, quant), _q(sd[prefix + "conv.weight"], quant), padding=1), quant)
    if train:
        var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = sd[prefix + "bn.running_mean"], sd[prefix + "bn.running_var"]
    scale = sd[prefix + "bn.weight"] / torch.sqrt(var + EPS)
    shift = sd[prefix + "bn.bias"] - mean * scale
    return torch.relu(y * scale[None, :, None, None] + shift[None, :, None, None])


def tracknet_logits(sd: Dict[str, torch.Tensor], x: torch.Tensor, train: bool = False,
                    quant: Quant = None) -> torch.Tensor:
    """(N, C_in, H, W) float32 input in [0, 1] -> (N, L, H, W) logits."""

    def block(t, name, n):
        for i in range(n):
            t = _conv_bn_relu(t, sd, f"{name}.conv_{i + 1}.", train, quant)
        return t

    n = dict(BLOCKS)
    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
    x1 = block(x, "down_block_1", n["down_block_1"])
    x2 = block(F.max_pool2d(x1, 2), "down_block_2", n["down_block_2"])
    x3 = block(F.max_pool2d(x2, 2), "down_block_3", n["down_block_3"])
    t = block(F.max_pool2d(x3, 2), "bottleneck", n["bottleneck"])
    t = block(torch.cat([up(t), x3], 1), "up_block_1", n["up_block_1"])
    t = block(torch.cat([up(t), x2], 1), "up_block_2", n["up_block_2"])
    t = block(torch.cat([up(t), x1], 1), "up_block_3", n["up_block_3"])
    w, b = sd["predictor.weight"], sd["predictor.bias"]
    return _qg(F.conv2d(_q(t, quant), _q(w, quant)), quant) + b[None, :, None, None]


def inpaintnet(sd: Dict[str, torch.Tensor], coords: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """(N, L, 2) coordinates and (N, L, 1) mask -> (N, L, 2) in [0, 1]."""

    def layer(t, name):
        return F.leaky_relu(F.conv1d(t, sd[name + ".conv.weight"], sd[name + ".conv.bias"],
                                     padding=1), 0.01)

    x = torch.cat([coords, mask], -1).to(torch.float32).transpose(1, 2)
    x1 = layer(x, "down_1")
    x2 = layer(x1, "down_2")
    x3 = layer(x2, "down_3")
    t = layer(layer(x3, "bottleneck_1"), "bottleneck_2")
    t = layer(torch.cat([t, x3], 1), "up_1")
    t = layer(torch.cat([t, x2], 1), "up_2")
    t = layer(torch.cat([t, x1], 1), "up_3")
    out = F.conv1d(t, sd["predictor.weight"], sd["predictor.bias"], padding=1)
    return torch.sigmoid(out).transpose(1, 2)
