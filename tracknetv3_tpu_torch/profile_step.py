"""Where the time of one TrackNet train step, or of serving one video,
goes on the card.

``python -m tracknetv3_tpu_torch.profile_step [--batch_size 10] [--steps 5]
[--batch_kind segmented|frame_mixup|resident] [--alpha -1]``
``python -m tracknetv3_tpu_torch.profile_step --serve [--batch_size 16]
[--conv_backend cudnn|hand_k3c|hand_9tap]``

Builds the published configuration (seq_len 8, bg_mode concat, 288x512,
bfloat16 convolutions) from a seed. Training: alpha 0.5 sample mixup,
Adam 1e-3, a fixed random uint8 batch that is already on the card
(``--batch_kind``: a plain batch, 5-window segments, a frame-mixup batch, or
indices into a 160-frame device-resident buffer; ``copy_kernels`` is then
the kernels of ``csrc/shift_copy.cu``). ``--serve``: ``run_staged`` in
``eval_mode`` weight over a random 480-frame video, the length that
``chip_smoke.py`` serves (chunks of ``batch_size`` windows: preprocess,
folded forward, ensemble, decode; then the ensemble flush and the one
fetch). Warms up, then traces ``--steps`` steps or videos with
``torch.profiler`` and prints one JSON line: host ms per step, device
kernel time per step (per chunk when serving) by category (a train step's
``batchnorm`` is the four kernels of ``csrc/batchnorm.cu``), the device's
busy share, peak device memory (training), and the heaviest kernels. Serving also times ``--steps``
videos untraced; its busy share is the traced device time over that
untraced wall time, so the profiler's own host cost is left out. Serving categories come from the ``serve::*`` profiler
ranges of ``inference.py`` and, inside the forward, from kernel names
(``conv3x3``: the hand-written conv kernels of ``csrc/conv3x3.cu``, which
``--conv_backend hand_k3c`` / ``hand_9tap`` serve through; convolution:
cuDNN's; the pool / upsample kernels; the rest elementwise). Needs the
card.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from .device import resolve_device
from .models.factory import get_model
from .training.optim import build_optimizer
from .training.steps import make_tracknet_train_step, sample_mixup_params

_CATEGORIES = (
    # the kernels of csrc/shift_copy.cu; first: their names hold "copy" too
    ("copy_kernels", ("window_copy", "repeat_rows_kernel", "roll_cols_kernel")),
    ("loss_kernels", ("wbce_disk",)),
    ("batchnorm", ("bn_stats", "bn_relu")),  # the kernels of csrc/batchnorm.cu
    ("conv3x3", ("conv3x3_",)),  # the kernels of csrc/conv3x3.cu
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


_POOL_UP = ("maxpool2x2_kernel", "up2x_nearest_kernel")
SERVE_FRAMES = 480
_CONV = dict(_CATEGORIES)["convolution"]
_HAND_CONV = dict(_CATEGORIES)["conv3x3"]


def _kernel_times(prof):
    """{kernel name: [device us, launches]} of the traced window (the device
    spans of the ``serve::*`` ranges are not kernels and are left out)."""
    by_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        kernel = not evt.key.startswith("serve::")
        if evt.device_type == torch.autograd.DeviceType.CUDA and kernel:
            by_kernel[evt.key][0] += evt.self_device_time_total
            by_kernel[evt.key][1] += evt.count
    return by_kernel


def _top(by_kernel, n):
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    return [{"name": k[:120], "ms_per_step": v[0] / 1e3 / n, "launches_per_step": v[1] / n}
            for k, v in top]


def _serve(args, dev) -> dict:
    from .inference import TrackNetPredictor
    from .training.checkpoint import save_checkpoint

    B, L, H, W = args.batch_size or 16, args.seq_len, 288, 512
    model = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(args.seed))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "TrackNet.pt")
        save_checkpoint(path, epoch=0, max_val_acc=0.0, model=model,
                        param_dict=dict(model_name="TrackNet", seq_len=L, bg_mode="concat"))
        p = TrackNetPredictor(path, batch_size=B, device=dev, conv_backend=args.conv_backend)
    rng = np.random.default_rng(args.seed)
    staged = p.stage_frames(rng.integers(0, 256, (SERVE_FRAMES, H, W, 3), dtype=np.uint8))
    chunks = -(-(SERVE_FRAMES - L + 1) // B)
    for _ in range(args.warmup):
        p.run_staged(staged)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        p.run_staged(staged)  # ends in a fetch: synchronised
    video_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            p.run_staged(staged)
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    n = args.steps * chunks
    by_kernel = _kernel_times(prof)
    device_ms = sum(v[0] for v in by_kernel.values()) / 1e3 / n
    ranges = defaultdict(float)  # device ms of the kernels each range launched
    for evt in prof.events():
        if evt.name.startswith("serve::") and evt.device_type == torch.autograd.DeviceType.CPU:
            ranges[evt.name[len("serve::"):]] += evt.device_time_total / 1e3 / n

    def ms_of(keys):
        hits = [v[0] for k, v in by_kernel.items() if any(s in k.lower() for s in keys)]
        return sum(hits) / 1e3 / n

    pool_up, hand_conv = ms_of(_POOL_UP), ms_of(_HAND_CONV)
    conv = ms_of(_CONV) - hand_conv  # cuDNN's: the hand kernels' names hold "conv" too
    # The port's own kernels are launched through ctypes, and the profiler
    # may not count them under the range that was open (it did not on torch
    # 2.11): then the ranges leave room for them in the device total, and
    # the forward's range holds torch's kernels only. Whichever reading puts
    # the ranges' sum nearer the device total is taken.
    own = pool_up + hand_conv
    in_ranges = sum(ranges.values())
    own_in_ranges = abs(device_ms - in_ranges) < abs(device_ms - in_ranges - own)
    cats = {
        "preprocess": ranges["preprocess"],
        "convolution": conv,
        "conv3x3": hand_conv,
        "pool_up_kernels": pool_up,
        "forward_elementwise": ranges["forward"] - conv - (own if own_in_ranges else 0.0),
        "ensemble": ranges["ensemble"],
        "decode": ranges["decode"],
    }
    cats["other"] = device_ms - sum(cats.values())
    traced = sum(ranges.values()) > 0
    measured = device_ms > 0
    return {
        "device": torch.cuda.get_device_name(0),
        "config": f"serve TrackNet seq_len {L} concat {H}x{W} bf16 weight, conv_backend "
                  f"{p.params['conv_backend']}, a {SERVE_FRAMES}-"
                  f"frame video in {chunks} chunks of {B} windows + flush + fetch",
        "host_ms_per_video": video_ms,
        "traced_host_ms_per_video": traced_ms,
        "device_kernel_ms_per_video": device_ms * chunks if measured else "not measured",
        "device_busy_share": device_ms * chunks / video_ms if measured else "not measured",
        "host_ms_per_chunk": video_ms / chunks,
        "device_kernel_ms_per_chunk": device_ms if measured else "not measured",
        "kernel_launches_per_chunk": sum(v[1] for v in by_kernel.values()) / n,
        "ms_per_chunk_by_category": cats if traced else "not measured",
        "own_kernels_counted_in_ranges": own_in_ranges,
        "top_kernels": _top(by_kernel, n),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve", action="store_true",
                    help="profile serving a video instead of a train step")
    ap.add_argument("--batch_size", type=int, default=None,
                    help="10 for a train step, 16 windows per serving chunk")
    ap.add_argument("--conv_backend", default=None,
                    choices=["cudnn", "hand_k3c", "hand_9tap"],
                    help="who computes the served forward's 3x3 convs (with --serve; "
                    "default: models.fused_forward.DEFAULT_CONV_BACKEND)")
    ap.add_argument("--batch_kind", default="plain",
                    choices=["plain", "segmented", "frame_mixup", "resident"],
                    help="what the train step assembles its input from")
    ap.add_argument("--alpha", type=float, default=0.5, help="sample-mixup alpha, -1 disables")
    ap.add_argument("--seq_len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    torch.backends.cudnn.benchmark = True
    if args.serve:
        out = _serve(args, dev)
        print(json.dumps(out), flush=True)
        return out
    B, L, H, W = args.batch_size or 10, args.seq_len, 288, 512
    rng = np.random.default_rng(args.seed)

    def u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    def centers(*shape):
        return np.stack([rng.integers(1, W, shape), rng.integers(1, H, shape)], -1).astype(np.int32)

    seg, n_res, n_rally = 5, 160, 4  # windows per segment; frames and rallies of the buffers
    batch = {"cxcy": centers(B, L)}
    if args.batch_kind == "segmented":
        batch.update(seg_rgb=u8(B // seg, seg + L - 1, H, W, 3), median=u8(B // seg, H, W, 3))
    elif args.batch_kind == "resident":
        batch.update(res_rgb_buf=u8(n_res, H, W, 3),
                     res_idx=rng.integers(0, n_res, (B, L)).astype(np.int32),
                     res_median_buf=u8(n_rally, H, W, 3).astype(np.float32),
                     res_median_idx=rng.integers(0, n_rally, B).astype(np.int32))
    else:
        batch.update(rgb=u8(B, L, H, W, 3), median=u8(B, H, W, 3))
    if args.batch_kind == "frame_mixup":
        batch.update(mix_pair=rng.integers(0, L, (B, L, 2)).astype(np.int32),
                     mix_pix_w=rng.random((B, L)).astype(np.float32),
                     mix_centers=centers(B, L, 2), mix_hm_w=rng.random((B, L)).astype(np.float32))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    mix = ()
    if args.alpha > 0:
        mix = tuple(torch.from_numpy(a).to(dev) for a in sample_mixup_params(rng, B, args.alpha))
    model = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(args.seed))
    model = model.to(dev, memory_format=torch.channels_last)
    opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
    step = make_tracknet_train_step(model, opt, "concat", args.alpha, sched)

    for i in range(args.warmup):
        step(batch, i, *mix)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            step(batch, args.warmup + i, *mix)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()

    by_kernel = _kernel_times(prof)
    by_cat = defaultdict(float)
    for k, (us, _) in by_kernel.items():
        by_cat[_category(k)] += us
    n = args.steps
    device_ms = sum(by_cat.values()) / 1e3 / n
    out = {
        "device": torch.cuda.get_device_name(0),
        "config": f"TrackNet seq_len {L} concat {H}x{W} batch {B} bf16 alpha {args.alpha} Adam, "
                  f"{args.batch_kind} batch",
        "host_ms_per_step": wall_ms / n,
        "device_kernel_ms_per_step": device_ms if device_ms > 0 else "not measured",
        "device_busy_share": device_ms / (wall_ms / n) if device_ms > 0 else "not measured",
        "peak_mem_bytes": peak,
        "ms_per_step_by_category": {k: v / 1e3 / n for k, v in sorted(by_cat.items())},
        "top_kernels": _top(by_kernel, n),
        # the loss and copy kernels one by one: device launches per step
        # (K1 is one launch per forward, K2 one per backward)
        "loss_and_copy_kernels": [
            {"name": k[:120], "ms_per_step": v[0] / 1e3 / n, "launches_per_step": v[1] / n}
            for k, v in sorted(by_kernel.items())
            if _category(k) in ("loss_kernels", "copy_kernels")],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
