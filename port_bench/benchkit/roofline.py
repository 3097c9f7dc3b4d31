"""Peaks of the card and the work of the model, counted from the
configuration's own channel counts.

Peaks: NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at the
full 700 W power limit; the same constants as ``chip_smoke.py`` holds
(a frozen copy). Work: the operations the model needs (a multiply-add is
two), each input read once and each output written once, whatever an
implementation pads or reads again: the first conv takes 27 input channels
(9 without a median), not the 32 or 16 a kernel pads them to.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2

# kernel-name patterns of each layer, kept broad so that a new kernel of
# the layer is still counted
CONV_PATTERNS = ("conv", "gemm", "xmma", "cutlass", "cudnn", "implicit", "wgrad", "dgrad")
BN_PATTERNS = ("bn_", "batch_norm", "batchnorm")

# (block, convs, width, spatial divisor)
_BLOCKS = (("down_block_1", 2, 64, 1), ("down_block_2", 2, 128, 2), ("down_block_3", 3, 256, 4),
           ("bottleneck", 3, 512, 8), ("up_block_1", 3, 256, 4), ("up_block_2", 2, 128, 2),
           ("up_block_3", 2, 64, 1))
_SKIPS = {"up_block_1": 256, "up_block_2": 128, "up_block_3": 64}


def in_channels(model: Dict) -> int:
    L = int(model["seq_len"])
    return {"": 3 * L, "concat": 3 * (L + 1)}[model["bg_mode"]]


def conv_layers(model: Dict) -> List[Tuple[int, int, int]]:
    """(pixels, in channels, out channels) of the 17 3x3 convs of one
    window."""
    H, W = int(model["height"]), int(model["width"])
    out, prev = [], in_channels(model)
    for block, n, width, div in _BLOCKS:
        for i in range(n):
            ci = prev + _SKIPS[block] if (i == 0 and block in _SKIPS) else prev
            out.append(((H // div) * (W // div), ci, width))
            prev = width
    return out


def predictor(model: Dict) -> Tuple[int, int, int]:
    return int(model["height"]) * int(model["width"]), 64, int(model["seq_len"])


def conv_flops(model: Dict) -> float:
    """FLOPs of the 17 3x3 convs of one window's forward."""
    return float(sum(2 * 9 * p * ci * co for p, ci, co in conv_layers(model)))


def forward_flops(model: Dict) -> float:
    """FLOPs of one window's forward: the 3x3 convs and the 1x1 predictor."""
    p, ci, co = predictor(model)
    return conv_flops(model) + 2.0 * p * ci * co


def _bound_s(flops: float, n_bytes: float) -> float:
    return max(flops / BF16_FLOPS, n_bytes / HBM_BYTES_PER_S)


def serve_conv_bound_s(model: Dict, windows: float) -> float:
    """Least time of the forward's convs (17 3x3 and the 1x1) over
    ``windows`` windows in bf16: for each conv the larger of its FLOPs at
    the bf16 peak and its bytes (input, weights and output, once) at the
    HBM rate, summed."""
    total = 0.0
    for p, ci, co in conv_layers(model):
        total += _bound_s(2 * 9 * p * ci * co * windows,
                          BF16 * (p * (ci + co) * windows + 9 * ci * co))
    p, ci, co = predictor(model)
    total += _bound_s(2 * p * ci * co * windows, BF16 * (p * (ci + co) * windows + ci * co))
    return total


def train_conv_flops(model: Dict, batch: int) -> float:
    """FLOPs of a train step's convolutions: each conv's forward, weight
    gradient and data gradient, except the first layer's data gradient
    (its input needs none), the 1x1 predictor included."""
    layers = conv_layers(model)
    fwd = [2 * 9 * p * ci * co * batch for p, ci, co in layers]
    p, ci, co = predictor(model)
    head = 2 * p * ci * co * batch
    return 3 * sum(fwd) - fwd[0] + 3 * head


def train_conv_bound_s(model: Dict, batch: int) -> float:
    return train_conv_flops(model, batch) / BF16_FLOPS


def bn_bytes(model: Dict, batch: int) -> float:
    """Bytes the 17 train-mode BatchNorm + ReLU layers of a step need: the
    forward reads y and writes out, the backward reads the gradient and y
    and writes dy, each once, in bf16."""
    y = sum(BF16 * p * co * batch for p, _, co in conv_layers(model))
    return 5.0 * y


def bn_bound_s(model: Dict, batch: int) -> float:
    return bn_bytes(model, batch) / HBM_BYTES_PER_S


def train_flops(model: Dict, batch: int) -> float:
    """Model FLOPs of a train step: 3 x the forward x the batch."""
    return 3.0 * forward_flops(model) * batch


def percent(bound_s: float, device_s: float):
    """``bound / device time`` in %, or None where nothing ran."""
    return 100.0 * bound_s / device_s if device_s > 0 else None
