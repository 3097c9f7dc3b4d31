"""Seeded weights, made on the device, and the checkpoint files the
program loads.

Every TrackNet or InpaintNet leaf comes from one ``torch.randn`` draw of a
``torch.Generator`` on the device, cut into leaves: conv kernels scaled to
LeCun-normal variance (1 / fan_in, clipped at 2 standard deviations),
biases zero, BatchNorm scale one, bias zero, running mean zero and running
variance one, as a fresh model has them. Names and shapes follow the
published model's state dict, which the port keeps.

The serving cells run a disk detector (``set_detector``): a random network
at full width with one path set by hand so that it finds the scene's disk,
as ``chip_smoke.disk_detector_checkpoint`` does, here with the random rest of
the network mixed into the predictor, so that every layer moves the
heatmap.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import torch

# the published U-Net: (block, convs, width)
TRACKNET_BLOCKS = (("down_block_1", 2, 64), ("down_block_2", 2, 128), ("down_block_3", 3, 256),
                   ("bottleneck", 3, 512), ("up_block_1", 3, 256), ("up_block_2", 2, 128),
                   ("up_block_3", 2, 64))
INPAINT_LAYERS = (("down_1", 3, 32), ("down_2", 32, 64), ("down_3", 64, 128),
                  ("bottleneck_1", 128, 256), ("bottleneck_2", 256, 256), ("up_1", 384, 128),
                  ("up_2", 192, 64), ("up_3", 96, 32), ("predictor", 32, 2))


def in_channels(seq_len: int, bg_mode: str) -> int:
    return {"": 3 * seq_len, "concat": 3 * (seq_len + 1)}[bg_mode]


def tracknet_convs(seq_len: int, bg_mode: str) -> List[Tuple[str, int, int]]:
    """(prefix, in channels, out channels) of the 17 3x3 convs, in order."""
    c_in = in_channels(seq_len, bg_mode)
    skips = {"up_block_1": 256, "up_block_2": 128, "up_block_3": 64}
    out, prev = [], c_in
    for block, n, width in TRACKNET_BLOCKS:
        for i in range(n):
            ci = prev + skips[block] if (i == 0 and block in skips) else prev
            out.append((f"{block}.conv_{i + 1}.", ci, width))
            prev = width
    return out


def tracknet_shapes(seq_len: int, bg_mode: str) -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {}
    for prefix, ci, co in tracknet_convs(seq_len, bg_mode):
        shapes[prefix + "conv.weight"] = (co, ci, 3, 3)
        for k in ("bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"):
            shapes[prefix + k] = (co,)
    shapes["predictor.weight"] = (seq_len, 64, 1, 1)
    shapes["predictor.bias"] = (seq_len,)
    return shapes


def inpaint_shapes() -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name, ci, co in INPAINT_LAYERS:
        prefix = name + "." if name == "predictor" else name + ".conv."
        shapes[prefix + "weight"] = (co, ci, 3)
        shapes[prefix + "bias"] = (co,)
    return shapes


def _seeded(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """One normal draw on ``device`` cut into the leaves of ``shapes``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kernels = {k: s for k, s in shapes.items() if len(s) > 1}
    flat = torch.randn(sum(math.prod(s) for s in kernels.values()), generator=gen,
                       device=device).clamp_(-2.0, 2.0)
    out, off = {}, 0
    for k, s in shapes.items():
        if k in kernels:
            n = math.prod(s)
            fan_in = math.prod(s[1:])
            out[k] = (flat[off:off + n].view(s) * (1.0 / math.sqrt(fan_in))).contiguous()
            off += n
        elif k.endswith(("bn.weight", "running_var")):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def tracknet_state(seq_len: int, bg_mode: str, seed: int, device) -> Dict[str, torch.Tensor]:
    return _seeded(tracknet_shapes(seq_len, bg_mode), seed, device)


def inpaint_state(seed: int, device) -> Dict[str, torch.Tensor]:
    return _seeded(inpaint_shapes(), seed, device)


@torch.no_grad()
def set_detector(sd: Dict[str, torch.Tensor], seq_len: int, bg_mode: str, det: Dict) -> None:
    """Set the disk-detector path in ``sd`` in place: in the first conv,
    channel i (i < L) is ReLU of frame i's colours summed at the centre tap
    against the median (``concat``) or against the fixed level
    ``det["level"]`` through the BatchNorm bias (no median); the next conv
    and the two of the last block carry each such channel on its own at the
    centre tap; the predictor maps channel i to frame i's logit as ``gain *
    (c - threshold)``, plus ``mix`` times a random mix of the other 56
    channels. No other channel feeds channels i < L."""
    L = seq_len
    first = sd["down_block_1.conv_1.conv.weight"]
    first[:L] = 0
    for i in range(L):
        if bg_mode == "concat":
            first[i, 3 + 3 * i: 6 + 3 * i, 1, 1] = 1.0
            first[i, 0:3, 1, 1] = -1.0
        else:
            first[i, 3 * i: 3 * i + 3, 1, 1] = 1.0
            sd["down_block_1.conv_1.bn.bias"][i] = -float(det["level"])
    for prefix, offset in (("down_block_1.conv_2.", 0), ("up_block_3.conv_1.", 128),
                           ("up_block_3.conv_2.", 0)):
        w = sd[prefix + "conv.weight"]
        w[:L] = 0
        for i in range(L):
            w[i, offset + i, 1, 1] = 1.0
    pw = sd["predictor.weight"]
    rest = pw[:, L:].clone()
    pw.zero_()
    pw[:, L:] = rest * float(det["mix"])
    for i in range(L):
        pw[i, i] = float(det["gain"])
    sd["predictor.bias"].fill_(-float(det["gain"]) * float(det["threshold"]))


def write_tracknet_checkpoint(path: str, sd: Dict[str, torch.Tensor], seq_len: int,
                              bg_mode: str) -> str:
    """A TrackNet checkpoint of ``sd`` in the program's file format."""
    from tracknetv3_tpu_torch.models.tracknet import TrackNet
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint

    with torch.device("meta"):
        model = TrackNet(in_channels(seq_len, bg_mode), seq_len)
    model.load_state_dict({k: v.cpu() for k, v in sd.items()}, assign=True)
    save_checkpoint(path, epoch=0, max_val_acc=0.0, model=model,
                    param_dict={"model_name": "TrackNet", "seq_len": seq_len,
                                "bg_mode": bg_mode})
    return path


def write_inpaint_checkpoint(path: str, sd: Dict[str, torch.Tensor], seq_len: int) -> str:
    from tracknetv3_tpu_torch.models.inpaintnet import InpaintNet
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint

    with torch.device("meta"):
        model = InpaintNet()
    model.load_state_dict({k: v.cpu() for k, v in sd.items()}, assign=True)
    save_checkpoint(path, epoch=0, max_val_acc=0.0, model=model,
                    param_dict={"model_name": "InpaintNet", "seq_len": seq_len})
    return path


def checkpoint_paths(tmp: str) -> Tuple[str, str]:
    return os.path.join(tmp, "TrackNet_best.pt"), os.path.join(tmp, "InpaintNet_best.pt")
