"""Model factory: ``get_model('TrackNet', seq_len, bg_mode, generator=...)``,
``get_model('InpaintNet')`` and ``get_model('TrackNetV1')``.

The TrackNet input channel count follows ``bg_mode`` and ``out_dim`` is
always ``seq_len``, as in the JAX package's factory; InpaintNet takes no
shape arguments (its ``seq_len`` is the window length of its callers).
Fresh weights use flax's default initialisers, drawn from the given
``torch.Generator``: conv kernels LeCun-normal (truncated normal, variance
1/fan_in), biases zero, BatchNorm scale one and bias zero, running mean
zero and variance one. TrackNetV1 (float32, no shape arguments) takes its
published module's initialisation (``BallTrackerNet._init_weights``): conv
kernels uniform in [-0.05, 0.05], biases zero, BatchNorm as above.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..config import tracknet_in_channels
from .inpaintnet import InpaintNet
from .tracknet import TrackNet
from .tracknet_v1 import ARCH as V1_ARCH
from .tracknet_v1 import TrackNetV1

# std of a unit normal truncated to [-2, 2]: flax divides by it so the
# truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    fan_in = w[0].numel()  # in-channels x kernel taps
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def get_model(
    model_name: str,
    seq_len: Optional[int] = None,
    bg_mode: Optional[str] = None,
    *,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> nn.Module:
    """Build a freshly initialised model (on the CPU; move it with ``.to``).
    ``dtype`` is TrackNet's working dtype; InpaintNet and TrackNetV1 are
    always float32."""
    if model_name == V1_ARCH:
        model = TrackNetV1()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.uniform_(-0.05, 0.05, generator=generator)
                    m.bias.zero_()
        return model
    if model_name == "TrackNet":
        if seq_len is None:
            raise ValueError("TrackNet requires seq_len")
        model = TrackNet(tracknet_in_channels(seq_len, bg_mode or ""), seq_len, dtype=dtype)
    elif model_name == "InpaintNet":
        model = InpaintNet()
    else:
        raise ValueError(f"Invalid model name: {model_name!r}")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                _lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
    return model
