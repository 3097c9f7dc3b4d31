#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port's training path (``tracknetv3_tpu_torch``) at the full
width of the published TrackNet configuration (seq_len 8, bg_mode concat,
288x512, batch 10, alpha 0.5 mixup, Adam 1e-3) with random weights made
from a seed, and holds each hand-written kernel against its plain PyTorch
version. One JSON line per phase; any failed phase exits nonzero.

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the CUDA kernels from ``tracknetv3_tpu_torch/csrc`` (nvcc,
   sm_90a), timed;
3. kernel vs plain at the main-path shape (10, 288, 512, 8), plain and
   mixup targets, logits reaching the clamp: loss relative error <= 1e-5,
   max |dz - dz_plain| <= 1e-5 * max |dz_plain|; median kernel and plain
   times beside each kernel's bound;
4. the slice: a synthetic dataset (numpy only, in the loader's npz cache
   formats) and ``tracknetv3_tpu_torch.train.main`` for one epoch, then
   ``--resume_training`` to epoch 2; each kernel must have launched once
   per train step; losses finite, checkpoints reload, val metrics back;
   then ms/step of the full-width step and peak device memory;
5. step parity: one float32 train step (TF32 off, deterministic cuDNN)
   through the kernel loss and through the plain loss from the same
   weights and batch: loss relative error <= 1e-5, relative L2 error of
   each parameter gradient <= 1e-4.

Then the ``{"kernels": [...]}`` line, the card line from ``nvidia-smi``,
and as the last line ``{"ok": true, "device": {...}}``. Exits with 2,
printing no result, where CUDA is missing or the package is not beside
this script.
"""

from __future__ import annotations

import copy
import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B, H, W, L = 10, 288, 512, 8  # the main path's loss shape (README config)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# float operations per element, counted from csrc/wbce_disk.cu: label
# (two squared distances, compares, blend) + sigmoid/log terms + loss
FWD_OPS_PER_ELEM = 30
BWD_OPS_PER_ELEM = 40


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"chip_smoke: phase {phase} failed: {msg}")


# ---------------------------------------------------------------- timing


def time_launches(fn, n: int = 30, windows: int = 5) -> float:
    """Device time per call in ms, the median over ``windows`` windows of
    ``n`` calls. Before each window the card spins so that the host can
    queue all ``n`` calls; one event pair spans them, so host launch
    overhead is hidden, as it is inside a busy training step."""
    import torch

    fn(0)  # warm-up
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return statistics.median(per_call)


def bound_ms(n_bytes: int, n_ops: int):
    """Least time on the card for the work: (ms, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- phases


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card})
    return card


def phase_build():
    from tracknetv3_tpu_torch.ops import cuda_build, wbce_disk

    t0 = time.time()
    path, log = cuda_build.build(wbce_disk.SOURCE)
    wbce_disk._lib()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "entry function" in ln]
    emit({"phase": "build", "source": f"tracknetv3_tpu_torch/csrc/{wbce_disk.SOURCE}",
          "library": os.path.relpath(path, ROOT), "seconds": round(time.time() - t0, 3),
          "ptxas": regs})


def _logits_np(seed: int) -> np.ndarray:
    """Logits (B, L, H, W) with tails past the clamp (|z| > 16.2). Values
    within 1e-3 of the clamp boundary +-16.1181 move off it: there the
    plain version's clamp gradient (torch passes it at equality) and the
    kernel's strict test may disagree on an exact tie."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, L, H, W), dtype=np.float32) * np.float32(8.0)
    near = np.abs(np.abs(z) - 16.1181) < 1e-3
    z[near] += np.float32(0.01) * np.sign(z[near])
    return z


def _centers_np(rng) -> np.ndarray:
    cx = rng.integers(0, W, (B, L))
    cy = rng.integers(0, H, (B, L))
    cx[0, 1] = cy[0, 1] = 0  # one frame without a ball
    return np.stack([cx, cy], axis=-1).astype(np.int32)


def phase_kernels():
    import torch

    from tracknetv3_tpu_torch.ops import wbce_disk as wd

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cxcy = torch.from_numpy(_centers_np(rng)).to(dev)
    perm = torch.from_numpy(rng.permutation(B)).to(dev)
    lam = rng.beta(0.5, 0.5, B)
    lam = torch.from_numpy(np.maximum(lam, 1 - lam).astype(np.float32)).to(dev)
    cases = {
        "plain": wd.pack_plain_targets(cxcy),
        "mixup": wd.pack_mixup_targets(cxcy, perm, lam),
    }
    z = torch.from_numpy(_logits_np(0)).to(dev)  # (B, L, H, W)
    clamp_share = float((z.abs() > 16.2).float().mean())
    err = {"fwd": 0.0, "bwd": 0.0}
    for name, (cxcy2, w) in cases.items():
        a = z.movedim(1, -1).detach().requires_grad_()
        loss_k = wd.wbce_disk_loss(a, cxcy2, w)
        loss_k.backward()
        b = z.movedim(1, -1).detach().requires_grad_()
        loss_p = wd.wbce_disk_loss_plain(b, cxcy2, w)
        loss_p.backward()
        torch.cuda.synchronize()
        lk, lp = float(loss_k.detach()), float(loss_p.detach())
        rel = abs(lk - lp) / abs(lp)
        dz_err = float((a.grad - b.grad).abs().max())
        dz_max = float(b.grad.abs().max())
        emit({"phase": "kernel_vs_plain", "targets": name, "loss_kernel": lk,
              "loss_plain": lp, "loss_rel_err": rel, "dz_max_abs_err": dz_err,
              "dz_plain_max": dz_max, "clamped_share": clamp_share})
        if not (math.isfinite(lk) and rel <= 1e-5):
            fail("kernel_vs_plain", f"{name}: loss {lk} vs plain {lp} (rel {rel})")
        if not dz_err <= 1e-5 * dz_max:
            fail("kernel_vs_plain", f"{name}: dz err {dz_err} > 1e-5 * {dz_max}")
        err["fwd"] = max(err["fwd"], abs(lk - lp))
        err["bwd"] = max(err["bwd"], dz_err)

    # Times at the main path's shape, mixup targets. Three copies of the
    # logits (141 MB, past the 50 MB L2) rotate so each call reads cold data.
    cxcy2, w = cases["mixup"]
    centers, wf = wd.flatten_targets(cxcy2, w)
    zs = [z.clone() for _ in range(3)]
    g = torch.ones((), device=dev)
    ms = {
        "fwd": time_launches(lambda i: wd.wbce_disk_forward(zs[i % 3], centers, wf)),
        "bwd": time_launches(lambda i: wd.wbce_disk_backward(zs[i % 3], centers, wf, g)),
    }
    with torch.no_grad():
        plain_fwd = time_launches(
            lambda i: wd.wbce_disk_loss_plain(zs[i % 3].movedim(1, -1), cxcy2, w)
        )
    leaves = [t.movedim(1, -1).detach().requires_grad_() for t in zs]
    graphs = [wd.wbce_disk_loss_plain(t, cxcy2, w) for t in leaves]
    plain_bwd = time_launches(
        lambda i: torch.autograd.grad(graphs[i % 3], leaves[i % 3], retain_graph=True)
    )
    del graphs, leaves
    # each input read once, each output written once: logits, centers and
    # weights in; the loss (4 B) out forward; g (4 B) in and dz out backward
    n = B * L * H * W
    in_bytes = 4 * (n + centers.numel() + wf.numel())
    bound = {
        "fwd": bound_ms(in_bytes + 4, n * FWD_OPS_PER_ELEM),
        "bwd": bound_ms(in_bytes + 4 + 4 * n, n * BWD_OPS_PER_ELEM),
    }
    emit({"phase": "kernel_times", "shape_BHWL": [B, H, W, L], "kernel_ms": ms,
          "plain_ms": {"fwd": plain_fwd, "bwd": plain_bwd},
          "bound_ms": {k: v[0] for k, v in bound.items()},
          "bound_by": {k: v[1] for k, v in bound.items()}})
    return err, ms, {"fwd": plain_fwd, "bwd": plain_bwd}, bound


def _write_npz(path: str, **arrays) -> None:
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def write_synthetic_dataset(root: str, seed: int = 0) -> None:
    """Shuttlecock-layout dataset at 288x512 with numpy only: seeded
    textured backgrounds, a moving bright disk, label CSVs, and the
    loader's npz caches (so no PNG is decoded). Train: 2 matches x 2
    rallies x 40 frames; val: 1 match x 2 rallies x 40 frames."""
    from tracknetv3_tpu_torch.data.dataset import _slide_windows

    rng = np.random.default_rng(seed)
    T = 40
    yy, xx = np.mgrid[0:H, 0:W]
    for split, matches, step in (("train", (1, 2), 1), ("val", (1,), L)):
        parts = []
        rally_i = 0
        for m in matches:
            match_dir = os.path.join(root, split, f"match{m}")
            os.makedirs(os.path.join(match_dir, "csv"), exist_ok=True)
            for r in (1, 2):
                rally = f"1_{r:02d}_00"
                frame_dir = os.path.join(match_dir, "frame", rally)
                os.makedirs(frame_dir, exist_ok=True)
                bg = np.full((H, W, 3), (40, 90, 40), np.int32)
                bg = (bg + rng.integers(0, 40, (H, W, 3))).astype(np.uint8)
                frames = np.repeat(bg[None], T, axis=0)
                rows = []
                for t in range(T):
                    visible = not (r == 1 and 12 <= t < 16)  # a short occlusion
                    x = int(W * 0.1 + W * 0.8 * t / (T - 1))
                    y = int(H * 0.7 - H * 0.5 * math.sin(math.pi * t / (T - 1)))
                    if visible:
                        frames[t][(yy - y) ** 2 + (xx - x) ** 2 <= 16] = 255
                    rows.append((t, int(visible), x if visible else 0, y if visible else 0))
                with open(os.path.join(match_dir, "csv", f"{rally}_ball.csv"), "w",
                          newline="") as f:
                    wr = csv.writer(f)
                    wr.writerow(["Frame", "Visibility", "X", "Y"])
                    wr.writerows(rows)
                median = np.median(frames, axis=0).astype(np.uint8)
                _write_npz(os.path.join(frame_dir, f"cache_{H}x{W}_concat.npz"),
                           rgb=frames, median_resized=median)
                lab = np.asarray(rows, np.float32)
                win = np.asarray(_slide_windows(T, L, step, False))
                parts.append({
                    "id": np.stack([np.full_like(win, rally_i), win], -1).astype(np.int32),
                    "frame_id": lab[win, 0].astype(np.int64),
                    "coor": np.stack([lab[win, 2], lab[win, 3]], -1),
                    "vis": lab[win, 1],
                })
                rally_i += 1
        n_rally = rally_i
        _write_npz(os.path.join(root, f"img_config_{H}x{W}_{split}.npz"),
                   img_shape=np.tile(np.asarray([[W, H]], np.float64), (n_rally, 1)),
                   img_scaler=np.ones((n_rally, 2), np.float64))
        _write_npz(os.path.join(root, f"data_l{L}_s{step}_heatmap_{split}.npz"),
                   **{k: np.concatenate([p[k] for p in parts]) for k in parts[0]})


def phase_slice(tmp: str):
    import torch

    from tracknetv3_tpu_torch import train as train_cli
    from tracknetv3_tpu_torch.ops import wbce_disk as wd
    from tracknetv3_tpu_torch.training.checkpoint import load_model_from_checkpoint

    data_dir = os.path.join(tmp, "data")
    save_dir = os.path.join(tmp, "exp")
    t0 = time.time()
    write_synthetic_dataset(data_dir)
    data_s = time.time() - t0
    common = ["--seq_len", str(L), "--bg_mode", "concat", "--alpha", "0.5",
              "--batch_size", str(B), "--data_dir", data_dir, "--save_dir", save_dir]

    torch.cuda.reset_peak_memory_stats()
    wd.LAUNCHES.update(fwd=0, bwd=0)  # counts of the main path only
    t0 = time.time()
    out1 = train_cli.main(common + ["--epochs", "1"])
    out2 = train_cli.main(common + ["--epochs", "2", "--resume_training"])
    torch.cuda.synchronize()
    launches = dict(wd.LAUNCHES)
    train_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()

    steps = out2["step"]
    hist = out1["history"] + out2["history"]
    losses = [v for h in hist for v in (h["train_loss"], h["val_loss"])]
    reloaded = [load_model_from_checkpoint(os.path.join(save_dir, f"TrackNet_{k}.pt"))[1]
                for k in ("best", "cur")]
    emit({"phase": "slice", "train_steps": steps, "launches": launches,
          "epochs": [h["epoch"] for h in hist], "losses": losses,
          "val_res": hist[-1]["val_res"], "dataset_s": data_s, "train_s": train_s,
          "peak_mem_bytes": peak})
    if not steps or launches != {"fwd": steps, "bwd": steps}:
        fail("slice", f"launches {launches} != {steps} train steps")
    if [h["epoch"] for h in hist] != [0, 1]:
        fail("slice", "resume did not continue at epoch 2")
    if not all(math.isfinite(v) for v in losses):
        fail("slice", f"non-finite loss in {losses}")
    if any(pd.get("seq_len") != L for pd in reloaded):
        fail("slice", "checkpoint did not reload")
    if "accuracy" not in hist[-1]["val_res"]:
        fail("slice", "no val metrics")

    # Step time of the full-width step on a fixed batch, after warm-up.
    model = out2["model"]
    step_ms = _time_train_steps(model, data_dir)
    emit({"phase": "step_time", "config": "TrackNet seq_len 8 concat 288x512 batch 10 "
          "alpha 0.5 Adam bf16", "median_ms_per_step": statistics.median(step_ms),
          "ms_per_step": step_ms, "peak_mem_bytes": peak})
    return launches, statistics.median(step_ms), peak


def _first_batch(data_dir: str, dev):
    import torch

    from tracknetv3_tpu_torch.data.dataset import HeatmapBatchLoader, build_split_index

    index = build_split_index(data_dir, "train", L, 1)
    batch = next(iter(HeatmapBatchLoader(index, "concat", B, shuffle=True, seed=3,
                                         data_dir=data_dir)))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _time_train_steps(model, data_dir: str, n: int = 12):
    import torch

    from tracknetv3_tpu_torch.training.optim import build_optimizer
    from tracknetv3_tpu_torch.training.steps import make_tracknet_train_step, sample_mixup_params

    dev = torch.device("cuda")
    batch = _first_batch(data_dir, dev)
    opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
    step = make_tracknet_train_step(model, opt, "concat", 0.5, sched)
    perm, lam = (torch.from_numpy(a).to(dev)
                 for a in sample_mixup_params(np.random.default_rng(5), B, 0.5))
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, i, perm, lam)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[2:]


def phase_step_parity(data_dir: str):
    import torch

    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.ops import wbce_disk as wd
    from tracknetv3_tpu_torch.training.steps import (
        _to_model_input,
        assemble_tracknet_inputs,
        sample_mixup_inputs,
        sample_mixup_params,
    )

    dev = torch.device("cuda")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        batch = _first_batch(data_dir, dev)
        perm, lam = (torch.from_numpy(a).to(dev)
                     for a in sample_mixup_params(np.random.default_rng(7), B, 0.5))
        x = sample_mixup_inputs(assemble_tracknet_inputs(batch, "concat"), perm, lam)
        targets = wd.pack_mixup_targets(batch["cxcy"], perm, lam)
        base = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(11),
                         dtype=torch.float32)
        out = {}
        for name, loss_fn in (("kernel", wd.wbce_disk_loss), ("plain", wd.wbce_disk_loss_plain)):
            model = copy.deepcopy(base).to(dev, memory_format=torch.channels_last).train()
            loss = loss_fn(model(_to_model_input(x)).movedim(1, -1), *targets)
            loss.backward()
            out[name] = (float(loss.detach()), {k: p.grad.detach().clone()
                                       for k, p in model.named_parameters()})
            del model, loss
        lk, gk = out["kernel"]
        lp, gp = out["plain"]
        loss_rel = abs(lk - lp) / abs(lp)
        grad_rel = {k: float((gk[k] - gp[k]).norm() / gp[k].norm().clamp_min(1e-30))
                    for k in gp}
        worst = max(grad_rel, key=grad_rel.get)
        emit({"phase": "step_parity", "dtype": "float32", "tf32": False,
              "loss_kernel": lk, "loss_plain": lp, "loss_rel_err": loss_rel,
              "grad_rel_l2_max": grad_rel[worst], "grad_rel_l2_worst_param": worst})
        if not loss_rel <= 1e-5:
            fail("step_parity", f"loss rel err {loss_rel}")
        if not grad_rel[worst] <= 1e-4:
            fail("step_parity", f"{worst}: grad rel L2 err {grad_rel[worst]}")
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "tracknetv3_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "tracknetv3_tpu_torch package must sit beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    card = phase_env()
    phase_build()
    err, ms, plain_ms, bound = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, step_ms, peak = phase_slice(tmp)
        phase_step_parity(os.path.join(tmp, "data"))

    src = "tracknetv3_tpu_torch/csrc/wbce_disk.cu"
    replaces = {"fwd": "tracknetv3_tpu/ops/pallas_wbce.py:73",
                "bwd": "tracknetv3_tpu/ops/pallas_wbce.py:87"}
    emit({"kernels": [
        {"name": f"wbce_disk_{k}", "route": "cuda", "source": src,
         "replaces": replaces[k], "launches": launches[k], "max_abs_err": err[k],
         "ms": ms[k], "plain_ms": plain_ms[k], "bound_ms": bound[k][0],
         "bound_by": bound[k][1], "library_ms": None}
        for k in ("fwd", "bwd")
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
