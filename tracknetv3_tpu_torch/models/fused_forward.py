"""TrackNet inference forward with folded BatchNorm (the serving forward).

At inference BatchNorm is an affine map with constant parameters, so it
folds into the preceding bias-free convolution:

    W' = W * gamma / sqrt(var + eps)        (per output channel)
    b' = beta - mean * gamma / sqrt(var + eps)

``fold_batchnorm`` is the JAX package's (``models/fused_forward.py:36``)
in numpy, from the JAX variable trees or from the port's ``TrackNet`` (or
its state dict); its output keeps the JAX layouts (HWIO kernels).
``fused_params`` turns it into the port's tensors and
``tracknet_fused_forward`` is ``tracknet_fused_forward`` of the JAX package
(``:465-525``):

- each 3x3 conv is ``conv(x, W') + b'`` with b' added in float32, then
  ReLU and a cast to the working dtype (``_conv_relu``), in channels_last
  memory. ``conv_backend`` says who computes it: ``"cudnn"`` (``F.conv2d``
  and torch passes for the epilogue) or ``"hand_k3c"`` / ``"hand_9tap"``,
  the hand-written kernels of ``ops/conv3x3.py`` with the epilogue in
  their body (their plain version on the CPU). ``resolve_conv_backend`` is
  the one rule for an unset backend (``DEFAULT_CONV_BACKEND`` at bfloat16,
  ``"cudnn"`` at float32) and refuses a hand backend at float32 on the card;
- 2x2 max pool and nearest 2x upsample are the hand-written kernels of
  ``ops/pool_up2x.py`` on the card (their plain versions on the CPU);
- each up block concatenates ``[up2x(x), skip]``;
- the 1x1 predictor's float32 bias is added before the sigmoid.

TrackNetV1 (``models/tracknet_v1.py``) puts its BatchNorm after the ReLU,
so it cannot fold into the conv before, and folding it into the next conv
is not exact at the zero-padded border. ``v1_fused_params`` keeps each
block's conv with its bias and the BatchNorm as a per-channel float32
``scale = gamma / sqrt(var + eps)`` and ``shift = beta - mean * scale``;
``tracknet_v1_fused_forward`` runs the 18 blocks as ``bf16(relu(conv(x) +
b) * scale + shift)``, one rounding, in the conv kernels' epilogue mode on
the hand backends (torch passes after ``F.conv2d`` on ``cudnn``), with the
same pool and upsample kernels, no concat and no sigmoid: it returns the
256 class logits. ``class_maps`` turns them into the decode's input.

On the ``cudnn`` route one rounding differs from the JAX forward at
bfloat16: cuDNN returns each convolution in the working dtype, so the
float32 bias is added to a value already rounded to bfloat16, where JAX
adds it to the float32 accumulator. The hand backends (the bfloat16
default) add the bias to the accumulator and round once, as JAX does. The 1x1 predictor is ``F.conv2d``
on every route (and rounds before its bias at bfloat16). At float32 the
functions agree to accumulation order.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import tf32_off
from ..ops import conv3x3
from ..ops.pool_up2x import maxpool2x2, up2x_nearest
from . import tracknet_v1
from .convert import BLOCKS, tracknet_to_jax


def fold_batchnorm(
    variables: Union[Dict[str, Any], torch.nn.Module, Mapping[str, torch.Tensor]],
    eps: float = 1e-5,
) -> Dict[str, Any]:
    """Fold BN statistics and affine parameters into conv kernels + biases.

    ``variables`` is a JAX ``{"params", "batch_stats"}`` numpy tree, or the
    port's ``TrackNet`` or its state dict. Returns ``{block: [(kernel,
    bias), ...], "predictor": (kernel, bias)}`` in float32 numpy, kernels
    HWIO, as the JAX package's ``fold_batchnorm`` does.
    """
    if isinstance(variables, torch.nn.Module) or "params" not in variables:
        variables = tracknet_to_jax(variables)
    params = variables["params"]
    stats = variables["batch_stats"]
    folded: Dict[str, Any] = {}
    for block, n in BLOCKS:
        convs: List[Tuple[np.ndarray, np.ndarray]] = []
        for i in range(1, n + 1):
            sub = f"conv_{i}"
            kernel = np.asarray(params[block][sub]["conv"]["kernel"], np.float32)
            gamma = np.asarray(params[block][sub]["bn"]["scale"], np.float32)
            beta = np.asarray(params[block][sub]["bn"]["bias"], np.float32)
            mean = np.asarray(stats[block][sub]["bn"]["mean"], np.float32)
            var = np.asarray(stats[block][sub]["bn"]["var"], np.float32)
            inv = gamma / np.sqrt(var + eps)
            convs.append((kernel * inv, beta - mean * inv))
        folded[block] = convs
    folded["predictor"] = (
        np.asarray(params["predictor"]["kernel"], np.float32),
        np.asarray(params["predictor"]["bias"], np.float32),
    )
    return folded


# who computes the 3x3 convs: cuDNN, or a variant of the kernels of ops/conv3x3.py
CONV_BACKENDS = {"cudnn": None, "hand_k3c": "k3c", "hand_9tap": "9tap"}
# the backend of a bfloat16 forward whose caller names none: the faster
# hand route, which served 1.5x / 1.7x cuDNN's frames/s at batch 16 / 120 on
# an H100 (chip_smoke.py serve, PERF.md)
DEFAULT_CONV_BACKEND = "hand_9tap"


def resolve_conv_backend(conv_backend: Optional[str], dtype: torch.dtype,
                         device: Union[str, torch.device]) -> str:
    """Who computes the 3x3 convs of a forward in ``dtype`` on ``device``.
    Unset (None): ``DEFAULT_CONV_BACKEND`` at bfloat16, ``"cudnn"`` at any
    other dtype, since the conv kernels take bfloat16 only. A hand backend
    asked for at another dtype on the card raises rather than fall back; on
    the CPU every backend runs its plain version at any dtype."""
    if conv_backend is None:
        return DEFAULT_CONV_BACKEND if dtype == torch.bfloat16 else "cudnn"
    if conv_backend not in CONV_BACKENDS:
        raise ValueError(f"unknown conv_backend {conv_backend!r}, need one of "
                         f"{tuple(CONV_BACKENDS)}")
    hand = CONV_BACKENDS[conv_backend] is not None
    if hand and dtype != torch.bfloat16 and torch.device(device).type == "cuda":
        raise ValueError(f"conv_backend {conv_backend!r} runs the bfloat16 conv kernels, the "
                         f"working dtype is {dtype}: ask for 'cudnn' or leave it unset")
    return conv_backend


def fused_params(folded: Dict[str, Any], dtype: torch.dtype,
                 device: Union[str, torch.device],
                 conv_backend: Optional[str] = None) -> Dict[str, Any]:
    """Folded numpy weights -> device tensors for ``tracknet_fused_forward``.
    ``cudnn``: OIHW kernels in ``dtype`` (channels_last memory) and float32
    biases shaped (1, C, 1, 1). A hand backend: each 3x3 kernel packed by
    ``conv3x3.pack_weights`` (input channels padded to its multiple) and a
    flat float32 bias; the predictor as for ``cudnn``. ``conv_backend`` goes
    through ``resolve_conv_backend``. ``"dtype"`` and ``"conv_backend"``
    record the working dtype and the backend."""
    conv_backend = resolve_conv_backend(conv_backend, dtype, device)

    def bias_f32(bias):
        return torch.from_numpy(np.array(bias, np.float32)).to(device)

    def conv(kernel, bias):
        w = torch.from_numpy(np.array(kernel.transpose(3, 2, 0, 1), np.float32))
        w = w.to(device, dtype).contiguous(memory_format=torch.channels_last)
        return w, bias_f32(bias).reshape(1, -1, 1, 1)

    def packed(kernel, bias):
        return conv3x3.pack_weights(kernel, dtype, device=device), bias_f32(bias)

    conv3 = conv if conv_backend == "cudnn" else packed
    out: Dict[str, Any] = {"dtype": dtype, "conv_backend": conv_backend}
    for block, _ in BLOCKS:
        out[block] = [conv3(k, b) for k, b in folded[block]]
    out["predictor"] = conv(*folded["predictor"])
    return out


def _conv_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               backend: str = "cudnn") -> torch.Tensor:
    variant = CONV_BACKENDS[backend]
    if variant is not None:
        return conv3x3.conv3x3_bias_relu(x, w, b, variant=variant)
    y = F.conv2d(x, w, padding=1)
    return torch.add(y, b).relu_().to(x.dtype)  # bias in float32


def _block(x: torch.Tensor, convs, backend: str) -> torch.Tensor:
    for w, b in convs:
        x = _conv_relu(x, w, b, backend)
    return x


def _up(x_small: torch.Tensor, skip: torch.Tensor, convs, backend: str) -> torch.Tensor:
    return _block(torch.cat([up2x_nearest(x_small), skip], dim=1), convs, backend)


def _to_working_layout(x: torch.Tensor, dtype: torch.dtype, channels: int) -> torch.Tensor:
    """NHWC ``x`` -> an NCHW view of channels_last memory in ``dtype``, in one
    copy; with ``channels`` above x's, zero channels are appended (the hand
    convs' first layer)."""
    x = x.permute(0, 3, 1, 2)
    if channels == x.shape[1]:
        return x.to(dtype).contiguous(memory_format=torch.channels_last)
    out = torch.empty((x.shape[0], channels) + tuple(x.shape[2:]), dtype=dtype,
                      device=x.device, memory_format=torch.channels_last)
    out[:, : x.shape[1]] = x
    out[:, x.shape[1]:] = 0
    return out


def tracknet_fused_forward(params: Dict[str, Any], x: torch.Tensor, *,
                           apply_sigmoid: bool = True) -> torch.Tensor:
    """Folded-BN TrackNet forward.

    Args:
        params: ``fused_params(fold_batchnorm(...), dtype, device,
            conv_backend)``; its backend computes the 3x3 convs.
        x: (B, H, W, C_in) NHWC model input (the JAX package's layout).

    Returns:
        (B, H, W, L) float32 probabilities (logits with ``apply_sigmoid``
        False), an NHWC view of channels_last memory. At a float32 working
        dtype cuDNN runs without TF32.
    """
    dtype = params["dtype"]
    backend = params["conv_backend"]
    fp32 = dtype == torch.float32 and x.device.type == "cuda"
    with tf32_off() if fp32 else contextlib.nullcontext():
        channels = x.shape[-1]
        if backend != "cudnn":
            channels = conv3x3.padded_channels(channels)
        x = _to_working_layout(x, dtype, channels)
        x1 = _block(x, params["down_block_1"], backend)
        x2 = _block(maxpool2x2(x1), params["down_block_2"], backend)
        x3 = _block(maxpool2x2(x2), params["down_block_3"], backend)
        x = _block(maxpool2x2(x3), params["bottleneck"], backend)
        x = _up(x, x3, params["up_block_1"], backend)
        x = _up(x, x2, params["up_block_2"], backend)
        x = _up(x, x1, params["up_block_3"], backend)
        w, b = params["predictor"]
        logits = torch.add(F.conv2d(x, w), b)  # float32
    out = torch.sigmoid(logits) if apply_sigmoid else logits
    return out.permute(0, 2, 3, 1)


def v1_fused_params(model_or_state, dtype: torch.dtype, device: Union[str, torch.device],
                    conv_backend: Optional[str] = None) -> Dict[str, Any]:
    """A ``TrackNetV1`` (or its state dict) -> device tensors for
    ``tracknet_v1_fused_forward``: per block the 3x3 kernel as
    ``fused_params`` lays it out for the backend, and the float32 bias,
    ``scale`` and ``shift`` (flat), with what follows the block (``""``,
    ``"pool"`` or ``"up"``). ``conv_backend`` goes through
    ``resolve_conv_backend``."""
    conv_backend = resolve_conv_backend(conv_backend, dtype, device)
    layers = []
    for (w, b, gamma, beta, mean, var), (_, _, after) in zip(
            tracknet_v1.blocks(model_or_state), tracknet_v1.layer_channels()):
        scale = gamma / torch.sqrt(var + tracknet_v1.EPS)
        shift = beta - mean * scale
        if conv_backend == "cudnn":
            kernel = w.to(device, dtype).contiguous(memory_format=torch.channels_last)
        else:
            kernel = conv3x3.pack_weights(w.permute(2, 3, 1, 0), dtype, device=device)
        layers.append((kernel, *(v.to(device).contiguous() for v in (b, scale, shift)), after))
    return {"dtype": dtype, "conv_backend": conv_backend, "arch": tracknet_v1.ARCH,
            "layers": layers}


def _conv_relu_affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, backend: str) -> torch.Tensor:
    variant = CONV_BACKENDS[backend]
    if variant is not None:
        return conv3x3.conv3x3_bias_relu(x, w, b, variant=variant, scale=scale, shift=shift)
    y = torch.add(F.conv2d(x, w, padding=1), b.reshape(1, -1, 1, 1)).relu_()  # float32
    return (y * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)).to(x.dtype)


def tracknet_v1_fused_forward(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """TrackNetV1's serving forward.

    Args:
        params: ``v1_fused_params(...)``; its backend computes the convs.
        x: (B, H, W, 9) NHWC windows in [0, 1], H and W multiples of 8.

    Returns:
        (B, H, W, 256) class logits in the working dtype, an NHWC view of
        channels_last memory. At a float32 working dtype cuDNN runs without
        TF32.
    """
    dtype = params["dtype"]
    backend = params["conv_backend"]
    fp32 = dtype == torch.float32 and x.device.type == "cuda"
    with tf32_off() if fp32 else contextlib.nullcontext():
        channels = x.shape[-1]
        if backend != "cudnn":
            channels = conv3x3.padded_channels(channels)
        x = _to_working_layout(x, dtype, channels)
        for w, b, scale, shift, after in params["layers"]:
            x = _conv_relu_affine(x, w, b, scale, shift, backend)
            if after == "pool":
                x = maxpool2x2(x)
            elif after == "up":
                x = up2x_nearest(x)
    return x.permute(0, 2, 3, 1)


def class_maps(logits: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) class logits -> (B, H, W) float32 ``gray / 255``, where
    ``gray`` is the channel argmax (the first class on ties), the decode's
    input: its 0.5 threshold is ``gray > 127``, since 127 / 255 < 0.5 <
    128 / 255."""
    return logits.argmax(dim=1).to(torch.float32) / 255.0
