"""The work of TrackNetV1 (the original TrackNet), counted from the
configuration's own channel counts, against the card's peaks of
``roofline.py``.

Work: the operations the model needs (a multiply-add is two), each input
read once and each output written once, whatever an implementation pads or
reads again: the first conv takes 9 input channels, not the 16 a kernel
pads them to. The 18 blocks are 3x3 convs at full, 1/2, 1/4 and 1/8
resolution, pools after blocks 2, 4 and 7 and upsamples after 10, 13 and
15; each block's output is bfloat16, its float32 bias, scale and shift
are read once a call.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .roofline import BF16, BF16_FLOPS, CONV_PATTERNS, HBM_BYTES_PER_S, percent  # noqa: F401

# what follows each block: the next block runs at half (pool) or twice (up)
# the size
AFTER = ("", "pool", "", "pool", "", "", "pool", "", "", "up", "", "", "up", "", "up", "", "", "")


def conv_layers(model: Dict) -> List[Tuple[int, int, int]]:
    """(pixels, in channels, out channels) of the 18 3x3 convs of one
    window."""
    div, prev, out = 1, int(model["in_channels"]), []
    H, W = int(model["height"]), int(model["width"])
    for co, after in zip(model["widths"], AFTER):
        out.append(((H // div) * (W // div), prev, int(co)))
        prev = int(co)
        div = div * 2 if after == "pool" else div // 2 if after == "up" else div
    return out


def forward_flops(model: Dict) -> float:
    """FLOPs of one window's forward: the 18 3x3 convs."""
    return float(sum(2 * 9 * p * ci * co for p, ci, co in conv_layers(model)))


def conv_bound_s(model: Dict, windows: float) -> float:
    """Least time of the forward's 18 convs over ``windows`` windows in
    bf16: for each conv the larger of its FLOPs at the bf16 peak and its
    bytes (input, weights and output once, the three float32 vectors) at
    the HBM rate, summed."""
    total = 0.0
    for p, ci, co in conv_layers(model):
        flops = 2 * 9 * p * ci * co * windows
        n_bytes = BF16 * (p * (ci + co) * windows + 9 * ci * co) + 3 * 4 * co
        total += max(flops / BF16_FLOPS, n_bytes / HBM_BYTES_PER_S)
    return total


def is_v1(model: Dict) -> bool:
    return model.get("arch") == "TrackNetV1"
