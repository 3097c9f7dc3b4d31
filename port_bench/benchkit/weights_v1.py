"""Seeded TrackNetV1 weights, made on the device, with a hand-set detector
path, and the checkpoint the program loads.

Names and shapes follow the published ``BallTrackerNet`` state dict
(``conv{i}.block.0.*`` the conv, ``conv{i}.block.2.*`` the BatchNorm), which
the port keeps. Every leaf comes from two draws of one ``torch.Generator``
on the device: one normal draw cut into the conv kernels, He-scaled
(variance 2 / fan_in, clipped at 2 standard deviations) so that the random
channels keep their size through 18 ReLUs, and one uniform draw cut into the
conv biases (-0.1 .. 0.1) and the BatchNorm scales (0.8 .. 1.2), shifts
(-0.1 .. 0.1), running means (0 .. 0.2) and variances (0.8 .. 1.25), as a
trained network's differ from a fresh one's, so that the BatchNorm after
each ReLU is no identity and its order matters.

``set_detector`` sets one path by hand so that the network finds the
scene's disk. With no skip connections it runs through the 1/8 bottleneck:
channel 0 of the first block is ReLU of frame t's colours summed at the
centre tap against ``level`` (the disk's pixels sum to 2.76 or more, the
background's to 1.18 or less, ``scene.py``); channel 0 of every later block
carries it alone at the centre tap, through the pools and upsamples, with
its BatchNorm the identity. The last block maps it to the class-255 logit
as ``gain * (c - threshold)`` and to the class-0 logit as ``gain *
(threshold - c)``, plus ``mix`` times a random mix of the other 63
channels in every class, so that every layer moves every logit while the
argmax is 255 on the disk's 8x8 cells and 0 elsewhere.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# (out channels) of the 18 blocks, as published
WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 256, 256, 256, 128, 128, 64, 64, 256)
IN_CHANNELS = 9


def shapes() -> Dict[str, tuple]:
    out, prev = {}, IN_CHANNELS
    for i, co in enumerate(WIDTHS):
        pre = f"conv{i + 1}.block."
        out[pre + "0.weight"] = (co, prev, 3, 3)
        for k in ("0.bias", "2.weight", "2.bias", "2.running_mean", "2.running_var"):
            out[pre + k] = (co,)
        prev = co
    return out


# the uniform draw's range for each vector leaf: (low, high)
RANGES = {"0.bias": (-0.1, 0.1), "2.weight": (0.8, 1.2), "2.bias": (-0.1, 0.1),
          "2.running_mean": (0.0, 0.2), "2.running_var": (0.8, 1.25)}


def state(seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded state dict (float32 on ``device``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sh = shapes()
    kernels = {k: s for k, s in sh.items() if len(s) > 1}
    vectors = {k: s for k, s in sh.items() if len(s) == 1}
    flat = torch.randn(sum(math.prod(s) for s in kernels.values()), generator=gen,
                       device=device).clamp_(-2.0, 2.0)
    uni = torch.rand(sum(s[0] for s in vectors.values()), generator=gen, device=device)
    out, off = {}, 0
    for k, s in kernels.items():
        n = math.prod(s)
        out[k] = (flat[off:off + n].view(s) * math.sqrt(2.0 / math.prod(s[1:]))).contiguous()
        off += n
    off = 0
    for k, s in vectors.items():
        lo, hi = RANGES[k.split(".block.")[1]]
        out[k] = (lo + (hi - lo) * uni[off:off + s[0]]).contiguous()
        off += s[0]
    return out


@torch.no_grad()
def set_detector(sd: Dict[str, torch.Tensor], det: Dict) -> None:
    """Set the disk-detector path in ``sd`` in place (module docstring)."""
    n = len(WIDTHS)
    for i in range(1, n + 1):
        pre = f"conv{i}.block."
        w, b = sd[pre + "0.weight"], sd[pre + "0.bias"]
        if i < n:
            w[0] = 0.0
            if i == 1:
                w[0, 0:3, 1, 1] = 1.0  # frame t's three colours
                b[0] = -float(det["level"])
            else:
                w[0, 0, 1, 1] = 1.0
                b[0] = 0.0
            rows = [0]
        else:
            gain, th = float(det["gain"]), float(det["threshold"])
            w[:, 1:] *= float(det["mix"])
            w[:, 0] = 0.0
            w[255, 0, 1, 1], b[255] = gain, -gain * th
            w[0, 0, 1, 1], b[0] = -gain, gain * th
            rows = [0, 255]
        for r in rows:  # an identity BatchNorm on the path
            sd[pre + "2.weight"][r] = 1.0
            sd[pre + "2.bias"][r] = 0.0
            sd[pre + "2.running_mean"][r] = 0.0
            sd[pre + "2.running_var"][r] = 1.0


def write_checkpoint(path: str, sd: Dict[str, torch.Tensor], height: int, width: int) -> str:
    """A TrackNetV1 checkpoint of ``sd`` in the program's file format, its
    ``param_dict`` naming the architecture and the resolution."""
    from tracknetv3_tpu_torch.models.tracknet_v1 import TrackNetV1
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint

    with torch.device("meta"):
        model = TrackNetV1()
    full = {k: v.cpu() for k, v in sd.items()}
    for i in range(1, len(WIDTHS) + 1):
        full[f"conv{i}.block.2.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    model.load_state_dict(full, assign=True)
    save_checkpoint(path, epoch=0, max_val_acc=0.0, model=model,
                    param_dict={"model_name": "TrackNetV1", "seq_len": 3, "bg_mode": "",
                                "height": int(height), "width": int(width)})
    return path
