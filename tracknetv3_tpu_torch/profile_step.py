"""Where the time of one TrackNet train step goes on the card.

``python -m tracknetv3_tpu_torch.profile_step [--batch_size 10] [--steps 5]``

Builds the published configuration (seq_len 8, bg_mode concat, 288x512,
bfloat16 convolutions, alpha 0.5 sample mixup, Adam 1e-3) from a seed,
feeds it a fixed random uint8 batch, warms up, then traces ``--steps``
steps with ``torch.profiler`` and prints one JSON line: host ms per step,
device kernel time per step by category (convolution, loss kernels,
optimizer, reductions, elementwise, other), the device's busy share, and
the heaviest kernels. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from .device import resolve_device
from .models.factory import get_model
from .training.optim import build_optimizer
from .training.steps import make_tracknet_train_step, sample_mixup_params

_CATEGORIES = (
    ("loss_kernels", ("wbce_disk",)),
    ("optimizer", ("adam", "multi_tensor", "foreach")),
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "sm90", "implicit", "wgrad", "dgrad")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "cat", "copy")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch_size", type=int, default=10)
    ap.add_argument("--seq_len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cudnn.benchmark = True
    B, L, H, W = args.batch_size, args.seq_len, 288, 512
    rng = np.random.default_rng(args.seed)
    batch = {
        "rgb": torch.from_numpy(rng.integers(0, 256, (B, L, H, W, 3), dtype=np.uint8)).to(dev),
        "median": torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev),
        "cxcy": torch.from_numpy(np.stack(
            [rng.integers(1, W, (B, L)), rng.integers(1, H, (B, L))], -1
        ).astype(np.int32)).to(dev),
    }
    perm, lam = (torch.from_numpy(a).to(dev) for a in sample_mixup_params(rng, B, 0.5))
    model = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(args.seed))
    model = model.to(dev, memory_format=torch.channels_last)
    opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
    step = make_tracknet_train_step(model, opt, "concat", 0.5, sched)

    for i in range(args.warmup):
        step(batch, i, perm, lam)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            step(batch, args.warmup + i, perm, lam)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_cat = defaultdict(float)
    by_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        by_cat[_category(evt.key)] += us
        by_kernel[evt.key][0] += us
        by_kernel[evt.key][1] += evt.count
    n = args.steps
    device_ms = sum(by_cat.values()) / 1e3 / n
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    out = {
        "device": torch.cuda.get_device_name(0),
        "config": f"TrackNet seq_len {L} concat {H}x{W} batch {B} bf16 alpha 0.5 Adam",
        "host_ms_per_step": wall_ms / n,
        "device_kernel_ms_per_step": device_ms if device_ms > 0 else "not measured",
        "device_busy_share": device_ms / (wall_ms / n) if device_ms > 0 else "not measured",
        "ms_per_step_by_category": {k: v / 1e3 / n for k, v in sorted(by_cat.items())},
        "top_kernels": [
            {"name": k[:120], "ms_per_step": v[0] / 1e3 / n, "launches_per_step": v[1] / n}
            for k, v in top
        ],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
