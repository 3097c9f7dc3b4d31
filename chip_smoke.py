#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port's paths (``tracknetv3_tpu_torch``) at the full width
of the published TrackNet configuration (seq_len 8, bg_mode concat,
288x512, bf16 convolutions): training (batch 10, alpha 0.5 mixup, Adam
1e-3) from weights made from a seed, on plain batches and on segmented,
frame-mixup and device-resident ones, and single-video serving (eval_mode
weight, InpaintNet seq_len 16) from the checkpoint that training wrote,
with its 3x3 convs on cuDNN and on each hand-written conv kernel. It
holds each hand-written kernel against its plain PyTorch version. One
compact JSON line per phase (``--verbose`` prints the line of every shape
or case too); the train CLI's own lines go to stderr; any failed phase
exits nonzero.

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the five CUDA sources of ``tracknetv3_tpu_torch/csrc`` (nvcc,
   sm_90a, one process per source, all at once), timed; the count of
   ``HGMMA`` (wgmma), ``UTMALDG`` / ``UTMASTG`` (TMA) and ``SYNCS``
   (mbarrier) instructions in the conv library's SASS, and of ``UBLKCP``
   (1-D bulk copies) and ``SYNCS`` in the copy library's, which must not
   be 0;
3. kernel vs plain at the main-path shape (10, 288, 512, 8), plain and
   mixup targets, logits reaching the clamp, and mixup targets on logits
   that peak on the label disks: loss relative error <= 1e-5, max |dz -
   dz_plain| <= 1e-5 * max |dz_plain|; K1 gives the same loss bits in four
   calls; two wrong K1 forwards emulated from the plain version (the last
   item's partial dropped, every label row skipped) must fail the 1e-5
   bound on the peaked logits; kernel_times: median kernel and plain times
   of K1 and K2 beside each kernel's bound, the larger of the bytes at 3.35
   TB/s and the arithmetic instructions per element (read from the probe
   kernels of ``csrc/wbce_disk.cu``'s SASS, moves, convergence markers and
   uniform index math left out) at the issue rate of the SM clock
   ``nvidia-smi`` reads;
4. bn_vs_plain: the four BatchNorm + ReLU kernels (P4 statistics, P5
   normalise + ReLU, the backward's reduce and apply) against their plain
   versions at the train step's four shapes at batch 10, bf16 and float32,
   on data with per-channel means far from 0, exact zeros and a constant
   channel (variance 0, a ReLU tie): statistics against float64, the
   forward and the apply bit-exact on equal inputs, the whole op's output
   and dy, dgamma, dbeta within ``BN_BOUNDS``, which a backward without
   its mean term or its variance term must fail; bf16 times of each
   kernel, its plain version and ``torch.var_mean`` beside each bound;
5. the slice: a synthetic dataset (numpy only, in the loader's npz cache
   formats) and ``tracknetv3_tpu_torch.train.main`` for one epoch, then
   ``--resume_training`` to epoch 2; K1/K2 must have launched once per
   train step, each BatchNorm kernel 17 times per train step and the
   normalise 17 times per eval batch; losses finite, checkpoints reload,
   val metrics back; then ms/step of the full-width step and peak device
   memory;
6. step parity: one train step (TF32 off, deterministic cuDNN) from the
   same weights and batch through the kernels and with one part swapped
   for its plain version. float32: the plain loss, and the plain
   BatchNorm; loss relative error <= 1e-5, relative L2 error of each
   parameter gradient <= 1e-4. bfloat16: the plain BatchNorm within
   ``STEP_PARITY_BOUNDS``, which the two wrong backwards must fail;
7. pool_up_vs_plain: the 2x2 max pool (P6) and nearest-2x upsample (P7)
   kernels vs ``F.max_pool2d`` / ``F.interpolate`` at the serving forward's
   six shapes at batch 16, bf16 with NaN and -inf entries: bit-exact (max
   abs error 0, NaN positions equal); median kernel and plain times beside
   each shape's bytes bound;
8. conv_vs_plain: the two 3x3 conv kernels (``k3c``: P1, P2 with the sheet,
   P3 ``full``; ``9tap``: P2 without, P3 ``full-9mm``) against
   ``conv3x3_bias_relu_plain`` at the 11 distinct shapes of the serving
   forward's 17 convs at batch 16 and at two shapes with odd H and W, with
   and without the bias + ReLU epilogue, on inputs with exact zeros, a NaN
   and an inf: NaN and inf positions equal (and the NaN exactly on its 3x3
   neighbourhood), every other element within ``CONV_ULPS_BOUND`` bfloat16
   spacings, and the two kernels within it of each other, which five
   deliberately wrong convs (a tap dropped, dx mirrored, the halo not
   zero-filled, the bias added after the cast, the last input-channel chunk
   dropped) must fail; times of each kernel, the plain version, cuDNN alone
   and cuDNN with the torch epilogue passes, per shape and summed over the
   17 calls of one forward, beside the bound; conv_ablate: the ablation
   probe's six variants at (24, 72, 128, 256 -> 256), ms and share of the
   bf16 peak;
9. serve: ``stage_frames`` -> ``run_staged`` -> ``inpaint_trajectory`` ->
   ``write_pred_csv`` on a synthetic 480-frame 288x512 video, with the
   trained TrackNet and a seeded InpaintNet, at batch 16 (the CLI default)
   and 120: 480 CSV rows, every coordinate inside the frame, P6 and P7
   each launched 3x per chunk forwarded; after a warm-up, the median of 3
   runs of run_fps (frames / run_staged wall time), e2e_fps (host frames
   to CSV) and peak device memory; then the same through
   ``conv_backend="hand_k3c"`` and ``"hand_9tap"`` at batch 16 and 120 (17
   launches of the conv kernel per chunk forwarded);
   serve_vs_cpu, after each of these: one more served run, with the
   trained checkpoint's predictor bias lowered so that its heatmaps hold
   detections (``detecting_checkpoint``), whose chunks' window
   probabilities are copied to the host. Each chunk is held to the
   unfolded TrackNet in eval mode on the same input (phase 10's bf16 bound);
   a CPU predictor replays the probabilities through its own
   ``run_staged`` (ensemble, decode, the flushed tail rows) and
   ``inpaint_trajectory``: its rows must equal the card's, and so must
   InpaintNet's output on the served rows and on the disk's track with an
   occlusion cut into each pass (a masked frame may differ by 1 px: the
   two devices sum InpaintNet's convolutions in different orders);
10. serve_parity: three chunks of 16 windows of the served video through
   the folded forward on the ``cudnn`` route and through the unfolded TrackNet
   in eval mode (cuDNN, its BatchNorm on the P5 kernel, torch pool and
   upsample) from a checkpoint trained as phase 5's but with deterministic
   cuDNN, no autotuning and TF32 off (``deterministic_checkpoint``: it
   repeats from run to run, and so do the readings), TF32 off: float32 max
   |probability difference| <= 1e-5, mean <= 1e-6 (the bounds of
   ``tests/test_torch_fused_forward.py``); bfloat16, two roundings of one
   function, within ``SERVE_PARITY_BOUNDS``, set between these sound
   readings and the upper readings of deliberately wrong forwards
   (``wrong_forward``), each of which must fail the bound; the bfloat16
   chunks also go through both hand conv backends, under the same bound.

11. copy_vs_plain (run after phase 4): the three copy kernels (each
   ``window_copy`` case names the route ``copy_plan`` took)
   (``window_copy``, ``repeat_rows``, ``roll_cols``: the halo / shift,
   repeat and roll probes U1-U7) at the probes' shapes ((32, 264, 128)
   bf16, (32, 256, 256) for U4, float32 and bf16 for U6, (2, 32, 264, 128)
   for U7) and at the train path's (segments (2, 12, 288, 512, 3) uint8 ->
   (10, 8, ...), the median x5, 80 frames of a 160-frame resident buffer,
   10 float32 medians, the blend's two gathers), float inputs holding NaN
   payloads, -0.0, inf and denormals: every bit equal to the plain version
   and to one PyTorch call, while a wrong version of each (a start off by
   one, the unshifted tile, the other channels, the tiled repeat, a roll
   the other way) must differ; times beside the bytes bound;
12. seg_train (after phase 6): ``train.main`` for one epoch each with
   ``--segment_windows 5``, ``--frame_alpha 0.5`` (alone: the two-disk loss
   kernels; with ``--alpha 0.5``: materialised labels) and
   ``--resident_frames``: finite losses, val metrics, and the copy kernels'
   launches (1 ``window_copy`` + 1 ``repeat_rows`` per segmented step, 2
   ``window_copy`` per frame-mixup or resident step and per resident eval
   batch); seg_step_time: ms per step, peak memory and host bytes shipped
   on one fixed batch of each kind, the plain batch first and last;
   seg_parity: one float32 train step (TF32 off, deterministic cuDNN) on a
   segmented and on a resident batch against the plain batch holding the
   same windows: the assembled input bit-equal, loss and gradients
   bit-equal (or within phase 6's float32 bounds if a plain step does not
   repeat itself bit for bit).

``--conv_only`` runs phases 1, 2 and 8 alone (a first check of a changed
conv kernel), ``--copy_only`` phases 1, 2 and 11, ``--loss_only`` phases 1,
2 and 3; none prints a kernels line. With ``--copy_only`` or
``--loss_only``, ``--baseline DIR`` (a checkout of another commit, e.g. the
parent's unpacked by ``git archive`` into ``build/``) builds that tree's copy
and loss kernels from its own sources, holds them bit for bit against this
tree's and times the two in turns (old, new, new, old), with the host time
of a call of each forward or copy wrapper beside.

Then the ``{"kernels": [...]}`` line, the card line from ``nvidia-smi``,
and as the last line ``{"ok": true, "device": {...}}``. Exits with 2,
printing no result, where CUDA is missing or the package is not beside
this script.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B, H, W, L = 10, 288, 512, 8  # the main path's loss shape (README config)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
DEVICE = "cuda"  # of the BatchNorm, step-parity and serving phases
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense


_START = time.time()
VERBOSE = False  # --verbose: the per-shape detail lines go to the output too


def emit(obj, detail: bool = False) -> None:
    """One JSON line; a phase's line also carries the seconds since start.
    A ``detail`` line (one shape or case of a phase, which the phase's own
    line summarises) is printed only with ``--verbose``."""
    if detail and not VERBOSE:
        return
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.time() - _START, 1)}
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


def host_us_per_call(fn, n: int = 200, windows: int = 5) -> float:
    """Host time of one call in us, the median over ``windows`` windows of
    ``n`` calls, while the card spins so that no call waits for it: what a
    wrapper adds to the host's side of a step."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        per_call.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def bound_ms(n_bytes: int, n_ops: int, peak: float = F32_FLOPS):
    """Least time on the card for the work: (ms, what bounds it); ``peak``
    is the card's rate for the operations' type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak
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


def phase_build(baseline=None):
    from concurrent.futures import ThreadPoolExecutor

    from tracknetv3_tpu_torch.ops import (
        batchnorm,
        conv3x3,
        cuda_build,
        pool_up2x,
        shift_copy,
        wbce_disk,
    )

    modules = (wbce_disk, pool_up2x, batchnorm, conv3x3, shift_copy)
    t0 = time.time()
    with ThreadPoolExecutor(len(modules)) as pool:  # one nvcc per source, all at once
        builds = list(pool.map(lambda m: cuda_build.build(m.SOURCE), modules))
    seconds = time.time() - t0
    sources = {}
    for mod, (path, log) in zip(modules, builds):
        mod._lib()
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "entry function" in ln or "spill" in ln]
        emit({"phase": "build", "source": f"tracknetv3_tpu_torch/csrc/{mod.SOURCE}",
              "library": os.path.relpath(path, ROOT), "ptxas": regs}, detail=True)
        used = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
        sources[mod.SOURCE] = {"kernels": len(used), "max_registers": max(used, default=None),
                               "max_spill_bytes": max(spills, default=0)}
    path = {mod: p for mod, (p, _) in zip(modules, builds)}
    sass = {"conv3x3": _sass_counts(path[conv3x3], ("HGMMA", "UTMALDG", "UTMASTG", "SYNCS")),
            "shift_copy": _sass_counts(path[shift_copy], BULK_OPCODES)}
    emit({"phase": "build", "nvcc": "one process per source, all at once",
          "seconds": round(seconds, 3), "sources": sources,
          **{f"{k}_sass": v for k, v in sass.items()}})
    # the copy ring is built from bulk copies and mbarriers
    counts = sass["shift_copy"]
    if isinstance(counts, dict) and not all(counts[op] > 0 for op in BULK_OPCODES):
        fail("build", f"shift_copy: no bulk-copy or mbarrier instruction in its SASS: {counts}")
    if baseline is not None:  # the parent tree's copy and loss kernels, built before timing
        for mod in baseline:
            mod._lib()


# SASS of the 1-D bulk copies (UBLKCP: cp.async.bulk, both directions) and of
# the mbarrier operations (SYNCS)
BULK_OPCODES = ("UBLKCP", "SYNCS")


def _sass(library):
    """``cuobjdump -sass`` of a built library, or why it is not there."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None, "not measured: no cuobjdump"
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        return None, f"not measured: cuobjdump exited {out.returncode}"
    return out.stdout, None


def _sass_counts(library, opcodes):
    """How many instructions of each SASS opcode a built library holds (any
    suffix: ``UBLKCP.S.G`` counts as ``UBLKCP``): HGMMA (wgmma), UTMALDG /
    UTMASTG (TMA tensor loads / stores), UBLKCP (1-D bulk copies), SYNCS
    (mbarrier operations); "not measured" where cuobjdump is missing."""
    text, why = _sass(library)
    if text is None:
        return why
    return {op: len(re.findall(rf"\b{op}\b", text)) for op in opcodes}


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


PEAK = 12.0  # kernel_vs_plain's peaked logits: raised by this much on the label disks


def _label_rows(cxcy2, sigma: float):
    """(B, L) counts of the rows of each plane that can hold a label pixel:
    within sigma of a visible center's row (the rows K1 does not skip)."""
    c = cxcy2.cpu().numpy().astype(np.float32)  # (B, 2, 2, L)
    r = np.arange(H, dtype=np.float32)[None, None, :]
    s2 = np.float32(sigma) * np.float32(sigma)
    near = np.zeros((B, L, H), bool)
    for k in (0, 1):
        cx, cy = c[:, k, 0], c[:, k, 1]  # (B, L)
        vis = (cx != 0) | (cy != 0)
        d = r - cy[..., None]
        near |= vis[..., None] & (d * d <= s2)
    return near.sum(-1)


def _wrong_k1(name: str, z, cxcy2, w):
    """A wrong K1 forward, emulated from the plain version: ``last_item_dropped``
    leaves out the partial of the plan's last item (the last row of the last
    plane); ``label_rows_skipped`` takes every row for one no disk touches (y
    = 0 everywhere)."""
    import torch

    from tracknetv3_tpu_torch.ops import losses
    from tracknetv3_tpu_torch.ops import wbce_disk as wd

    logits = z.movedim(1, -1)  # (B, H, W, L)
    if name == "label_rows_skipped":
        return losses.wbce_from_logits(logits, torch.zeros_like(logits))
    y = wd.disk_labels_plain(cxcy2, w, H, W)
    part = losses.wbce_from_logits(logits[-1:, -1:, :, -1:], y[-1:, -1:, :, -1:])
    n, n_part = logits.numel(), W
    return (losses.wbce_from_logits(logits, y).double() * n - part.double() * n_part) / n


def _sass_functions(library):
    """{function: [opcode, ...]} of a built library's SASS, each through its
    first unpredicated EXIT (the straight path; subroutines placed after it,
    such as the IEEE division's slow path, are left out). None where
    cuobjdump is missing or fails."""
    text, _ = _sass(library)
    if text is None:
        return None
    funcs, name, done = {}, None, False
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name, done = m.group(1), False
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None and not done:
            funcs[name].append(m.group(2))
            done = m.group(2) == "EXIT" and m.group(1) is None
    return funcs


# SASS opcodes that are not arithmetic the loss needs: register moves (the
# compiler re-materialises constants per element), convergence markers and
# branches, loads, stores, constant and special-register reads. Opcodes of
# the uniform datapath (U...: index and parameter math) are left out too.
NOT_ARITHMETIC = ("MOV", "IMAD.MOV", "MOV32I", "BSSY", "BSYNC", "BRA", "BRX", "CALL", "RET",
                  "EXIT", "WARPSYNC", "NOP", "BAR", "S2R", "CS2R", "S2UR", "R2UR", "LDC", "LDG",
                  "STG", "LDS", "STS", "LD", "ST")


def _arithmetic(op: str) -> bool:
    return not op.startswith("U") and not any(
        op == x or op.startswith(x + ".") for x in NOT_ARITHMETIC)


def _per_element_instructions():
    """SASS instructions per element of K1 (on a label row and on a skipped
    row) and of K2, from the probe kernels of csrc/wbce_disk.cu: the
    arithmetic on each probe's straight path less ``wbce_probe_base``'s (its
    index math), plus 1 (K1's accumulating add, K2's scale). Beside it the
    whole straight path counted the same way (``straight_path``), the
    opcodes left out (``left_out``) and the MUFU among the arithmetic (the
    quarter-rate special-function instructions)."""
    from collections import Counter

    from tracknetv3_tpu_torch.ops import cuda_build, wbce_disk

    funcs = _sass_functions(cuda_build.library_path(wbce_disk.SOURCE))
    if funcs is None:
        return None
    base = funcs.get("wbce_probe_base")
    counts = {}
    for key, probe in (("fwd_label", "wbce_probe_fwd_label"), ("fwd_skip", "wbce_probe_fwd_skip"),
                       ("bwd", "wbce_probe_bwd")):
        ops = funcs.get(probe)
        if ops is None or base is None:
            return None
        arith = Counter(op for op in ops if _arithmetic(op))
        arith.subtract(op for op in base if _arithmetic(op))
        counts[key] = {"arithmetic": sum(arith.values()) + 1,
                       "straight_path": len(ops) - len(base) + 1,
                       "mufu": sum(v for op, v in arith.items() if op.startswith("MUFU")),
                       "arithmetic_opcodes": {op: v for op, v in sorted(arith.items()) if v},
                       "left_out": dict(sorted(Counter(
                           op for op in ops if not _arithmetic(op)).items()))}
    return counts


def _sm_clock_hz():
    """The SM clock's maximum as nvidia-smi reads it (Hz), None if unread."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    try:
        return float(smi.stdout.strip().splitlines()[0]) * 1e6
    except (ValueError, IndexError):
        return None


def issue_bound_ms(instructions: float, sms: int, clock_hz: float) -> float:
    """Instructions (per lane) over the card's issue rate: each SM's 4
    schedulers issue one warp instruction (32 lanes) a cycle."""
    return instructions / (sms * 4 * 32 * clock_hz) * 1e3


def phase_kernels(baseline=None):
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
    z_sym = torch.from_numpy(_logits_np(0)).to(dev)  # (B, L, H, W)
    # On logits symmetric about 0 a label pixel's term has the same expectation
    # with y = 1 as with y = 0, so a forward that loses the labels can pass.
    # ``peaked``: the same logits raised by PEAK on the disks, as a trained
    # TrackNet's heatmap peaks on the ball; there the labels move the loss.
    y_mix = wd.disk_labels_plain(*cases["mixup"], H, W).movedim(-1, 1)  # (B, L, H, W)
    z_peak = z_sym + PEAK * (y_mix > 0).float()
    near = ((z_peak.abs() - 16.1181).abs() < 1e-3)  # off the clamp boundary, as _logits_np
    z_peak = torch.where(near, z_peak + 0.01 * z_peak.sign(), z_peak)
    clamp_share = float((z_sym.abs() > 16.2).float().mean())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = wd.loss_plan(B, L, H, W, sms)
    err = {"fwd": 0.0, "bwd": 0.0}
    for name, (cxcy2, w), z in (("plain", cases["plain"], z_sym),
                                ("mixup", cases["mixup"], z_sym),
                                ("mixup_peaked", cases["mixup"], z_peak)):
        a = z.movedim(1, -1).detach().requires_grad_()
        loss_k = wd.wbce_disk_loss(a, cxcy2, w)
        loss_k.backward()
        b = z.movedim(1, -1).detach().requires_grad_()
        loss_p = wd.wbce_disk_loss_plain(b, cxcy2, w)
        loss_p.backward()
        centers, wf = wd.flatten_targets(cxcy2, w)
        # three more calls on one input
        repeats = [wd.wbce_disk_forward(z, centers, wf) for _ in range(3)]
        wrong = {k: float(_wrong_k1(k, z, cxcy2, w))
                 for k in ("last_item_dropped", "label_rows_skipped")}
        torch.cuda.synchronize()
        lk, lp = float(loss_k.detach()), float(loss_p.detach())
        rel = abs(lk - lp) / abs(lp)
        dz_err = float((a.grad - b.grad).abs().max())
        dz_max = float(b.grad.abs().max())
        bits = [int(t.view(torch.int32)) for t in [loss_k.detach(), *repeats]]
        wrong_rel = {k: abs(v - lp) / abs(lp) for k, v in wrong.items()}
        emit({"phase": "kernel_vs_plain", "targets": name, "loss_kernel": lk,
              "loss_plain": lp, "loss_rel_err": rel, "dz_max_abs_err": dz_err,
              "dz_plain_max": dz_max, "clamped_share": clamp_share,
              "loss_bits_4_calls": bits, "wrong_rel_err": wrong_rel,
              "label_rows": int(_label_rows(cxcy2, wd.SIGMA).sum()), "rows": B * L * H})
        if not (math.isfinite(lk) and rel <= 1e-5):
            fail("kernel_vs_plain", f"{name}: loss {lk} vs plain {lp} (rel {rel})")
        if not dz_err <= 1e-5 * dz_max:
            fail("kernel_vs_plain", f"{name}: dz err {dz_err} > 1e-5 * {dz_max}")
        if len(set(bits)) != 1:
            fail("kernel_vs_plain", f"{name}: K1 gave different bits in four calls: {bits}")
        for k, v in wrong_rel.items():
            if z is z_peak and not v > 1e-5:
                fail("kernel_vs_plain", f"{name}: the wrong forward {k} passes (rel {v})")
        err["fwd"] = max(err["fwd"], abs(lk - lp))
        err["bwd"] = max(err["bwd"], dz_err)

    # Times at the main path's shape, mixup targets. Three copies of the
    # logits (141 MB, past the 50 MB L2) rotate so each call reads cold data.
    cxcy2, w = cases["mixup"]
    centers, wf = wd.flatten_targets(cxcy2, w)
    zs = [z_sym.clone() for _ in range(3)]
    g = torch.ones((), device=dev)
    fwd = lambda i: wd.wbce_disk_forward(zs[i % 3], centers, wf)  # noqa: E731
    bwd = lambda i: wd.wbce_disk_backward(zs[i % 3], centers, wf, g)  # noqa: E731
    earlier = {}
    if baseline is not None:  # the parent's kernels, in turns: old, new, new, old
        _, old_wd = baseline
        old = {"fwd": lambda i: old_wd.wbce_disk_forward(zs[i % 3], centers, wf),
               "bwd": lambda i: old_wd.wbce_disk_backward(zs[i % 3], centers, wf, g)}
        new = {"fwd": fwd, "bwd": bwd}
        turns = {k: [time_launches(old[k]), time_launches(new[k]), time_launches(new[k]),
                     time_launches(old[k])] for k in ("fwd", "bwd")}
        earlier = {k: statistics.mean(v[0::3]) for k, v in turns.items()}
        host = [host_us_per_call(old["fwd"]), host_us_per_call(fwd), host_us_per_call(fwd),
                host_us_per_call(old["fwd"])]
        emit({"phase": "kernel_times", "what": "turns old, new, new, old (ms); the forward "
              "wrapper's host us per call in the same turns", "turns": turns,
              "fwd_host_us_per_call": host})
    ms = {"fwd": time_launches(fwd), "bwd": time_launches(bwd)}
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
    # weights in; the loss (4 B) out forward; g (4 B) in and dz out backward.
    # Beside the bytes, the instructions this data needs at the card's issue
    # rate: K1 pays the label path only on the rows a disk can touch.
    n = B * L * H * W
    in_bytes = 4 * (n + centers.numel() + wf.numel())
    bytes_ms = {"fwd": bound_ms(in_bytes + 4, 0)[0], "bwd": bound_ms(in_bytes + 4 + 4 * n, 0)[0]}
    per_elem, clock = _per_element_instructions(), _sm_clock_hz()
    issue_ms, label_elems = {}, int(_label_rows(cxcy2, wd.SIGMA).sum()) * W
    if per_elem is not None and clock is not None:
        fwd_instr = (label_elems * per_elem["fwd_label"]["arithmetic"]
                     + (n - label_elems) * per_elem["fwd_skip"]["arithmetic"])
        issue_ms = {"fwd": issue_bound_ms(fwd_instr, sms, clock),
                    "bwd": issue_bound_ms(n * per_elem["bwd"]["arithmetic"], sms, clock)}
    bound = {k: (max(bytes_ms[k], issue_ms.get(k, 0.0)),
                 "operations" if issue_ms.get(k, 0.0) > bytes_ms[k] else "bytes")
             for k in ("fwd", "bwd")}
    emit({"phase": "kernel_times", "shape_BHWL": [B, H, W, L], "kernel_ms": ms,
          "earlier_ms": earlier or "not measured",
          "plain_ms": {"fwd": plain_fwd, "bwd": plain_bwd},
          "bound_ms": {k: v[0] for k, v in bound.items()},
          "bound_by": {k: v[1] for k, v in bound.items()},
          "bytes_bound_ms": bytes_ms, "issue_bound_ms": issue_ms or "not measured",
          "per_element_sass": per_elem or "not measured", "sm_clock_max_hz": clock,
          "label_row_share": label_elems / n, "fwd_device_launches": 1,
          "fwd_plan": {"items": plan.items, "grid": plan.grid}})
    return err, ms, {"fwd": plain_fwd, "bwd": plain_bwd}, bound


# ---------------------------------------------------------------- BatchNorm

# NHWC shape of each BatchNorm + ReLU of the train step at batch 10, and how
# many of its 17 layers have it (down 1 / up 3, down 2 / up 2, down 3 / up 1,
# the bottleneck)
BN_SHAPES = {(B, 288, 512, 64): 4, (B, 144, 256, 128): 4, (B, 72, 128, 256): 6,
             (B, 36, 64, 512): 3}
BN_LAYERS = sum(BN_SHAPES.values())
BN_KERNELS = ("bn_stats", "bn_relu_fwd", "bn_relu_bwd_reduce", "bn_relu_bwd_apply")
# activation elements each kernel reads + writes, and per-channel float32
# vectors (gamma, running stats, st, bias, coefficients, gradients)
BN_TRAFFIC = {"bn_stats": (1, 9), "bn_relu_fwd": (2, 5), "bn_relu_bwd_reduce": (2, 9),
              "bn_relu_bwd_apply": (3, 7)}
# float32 operations per element, counted from csrc/batchnorm.cu
BN_OPS_PER_ELEM = {"bn_stats": 3, "bn_relu_fwd": 4, "bn_relu_bwd_reduce": 10,
                   "bn_relu_bwd_apply": 11}
BN_CONST_CHANNEL = 3  # constant 3.0 with bias 0: var 0 and a ReLU tie
# Statistics against float64 (relative; the mean over |mean| + std): the
# kernel read <= 5.8e-8, float32's own rounding. Kernel vs plain, relative
# L2: the reduce kernel's outputs on equal inputs, and the whole op's output
# and dy, dgamma, dbeta. Both sum every element in double, and read 0 at
# all four shapes in both dtypes; a backward without its variance term read
# 9.3e-3 or more, without its mean term 0.147 or more (PERF.md). The
# bounds sit between.
BN_BOUNDS = {"stats": 1e-6, "out": {"bfloat16": 1e-3, "float32": 1e-5},
             "grad": {"bfloat16": 1e-3, "float32": 1e-5}, "reduce": 1e-5}


def _bn_data(shape, dtype, seed: int, dev):
    """A layer's conv output y (NCHW view of channels_last memory): per
    channel a mean in [-8, 8] and a spread in [0.5, 2], 5% exact zeros and
    one constant channel; an output gradient g with a per-channel offset and
    a per-channel share of y's own standardised value (so both the mean and
    the variance terms of the backward matter); gamma, beta (0 where y is
    constant); running statistics."""
    import torch

    C = shape[-1]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi, *size):
        return lo + (hi - lo) * torch.rand(*size, generator=gen, device=dev)

    z = torch.randn(shape, generator=gen, device=dev)
    y = (z * u(0.5, 2.0, C) + u(-8.0, 8.0, C)).masked_fill(u(0, 1, *shape) < 0.05, 0.0)
    y[..., BN_CONST_CHANNEL] = 3.0
    g = u(-0.5, 0.5, C) + u(-1.0, 1.0, C) * z + torch.randn(shape, generator=gen, device=dev)
    beta = u(-0.5, 0.5, C)
    beta[BN_CONST_CHANNEL] = 0.0
    nchw = lambda t: t.to(dtype).permute(0, 3, 1, 2)  # noqa: E731
    return nchw(y), nchw(g), u(0.5, 1.5, C), beta, u(-1.0, 1.0, C), u(0.5, 2.0, C)


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _ulp_diff(a, b):
    """(max distance in units in the last place, count of unequal entries)
    of two tensors of one float dtype."""
    import torch

    ints, mag = {torch.bfloat16: (torch.int16, 0x7FFF), torch.float32: (torch.int32, 0x7FFFFFFF)}[
        a.dtype]

    def line(t):  # sign-magnitude bits -> a monotone integer line
        i = t.contiguous().view(ints).long()
        return torch.where(i < 0, -(i & mag), i)

    return int((line(a) - line(b)).abs().max()), int((a != b).sum())


def _stats_f64(y):
    """(mean, var) over (N, H, W) in float64, two-pass, no clamp."""
    yd = y.double()
    mean = yd.mean((0, 2, 3))
    return mean, (yd - mean[:, None, None]).square().mean((0, 2, 3))


def _bn_op_vs_plain(bn, y, g, gamma, beta, rm, rv):
    """The op through its Function with the kernels and with the plain
    versions: (out, dy, dgamma, dbeta) of each."""
    res = []
    for ops in (bn.KERNEL_OPS, bn.PLAIN_OPS):
        yy = y.detach().requires_grad_()
        w, b = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        out = bn.bn_relu(yy, w, b, rm.clone(), rv.clone(), True, ops)
        out.backward(g)
        res.append((out.detach(), yy.grad, w.grad, b.grad))
    return res


def phase_bn():
    """bn_vs_plain: the four BatchNorm kernels vs their plain versions at
    the train step's four shapes, bf16 and float32; times in bf16."""
    import torch

    from tracknetv3_tpu_torch.ops import batchnorm as bn

    dev = torch.device(DEVICE)
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
               "max_abs_err": 0.0, "bound_by": set()} for k in BN_KERNELS}
    worst = {}  # per dtype, over the four shapes
    for dtype, dname in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        for i, (shape, layers) in enumerate(BN_SHAPES.items()):
            y, g, gamma, beta, rm, rv = _bn_data(shape, dtype, 10 + i, dev)
            C = shape[-1]
            # statistics and the running update
            rmk, rvk, rmp, rvp = rm.clone(), rv.clone(), rm.clone(), rv.clone()
            st_k = bn.bn_stats(y, gamma, rmk, rvk)
            st_p = bn.bn_stats_plain(y, gamma, rmp, rvp)
            mean64, var64 = _stats_f64(y)
            scale = mean64.abs() + var64.sqrt()
            live = var64 > 0
            stats_err = {}
            for name, st in (("kernel", st_k), ("plain", st_p)):
                stats_err[name] = {
                    "mean": float(((st[0].double() - mean64).abs() / scale).max()),
                    "var": float(((st[1].double() - var64).abs() / var64)[live].max()),
                }
            tie = bool(st_k[1, BN_CONST_CHANNEL] == 0 and st_p[1, BN_CONST_CHANNEL] == 0)
            running = max(_rel_l2(rmk, rmp), _rel_l2(rvk, rvp))
            # each kernel on the plain version's inputs
            fwd_k, fwd_p = bn.bn_relu_fwd(y, st_p, beta), bn.bn_relu_fwd_plain(y, st_p, beta)
            red_k = bn.bn_relu_bwd_reduce(g, y, st_p, beta, True)
            red_p = bn.bn_relu_bwd_reduce_plain(g, y, st_p, beta, True)
            coef = red_p[2]
            dy_k = bn.bn_relu_bwd_apply(g, y, st_p, beta, coef)
            dy_p = bn.bn_relu_bwd_apply_plain(g, y, st_p, beta, coef)
            fwd_ulp, fwd_unequal = _ulp_diff(fwd_k, fwd_p)
            apply_ulp, apply_unequal = _ulp_diff(dy_k, dy_p)
            reduce_err = max(_rel_l2(a, b) for a, b in zip(red_k, red_p))
            # the whole op, and the backward with a term dropped
            (o_k, dy_ok, dw_k, db_k), (o_p, dy_op, dw_p, db_p) = _bn_op_vs_plain(
                bn, y, g, gamma, beta, rm, rv)
            op_ulp, op_unequal = _ulp_diff(o_k, o_p)
            op = {"out": _rel_l2(o_k, o_p), "dy": _rel_l2(dy_ok, dy_op),
                  "dgamma": _rel_l2(dw_k, dw_p), "dbeta": _rel_l2(db_k, db_p)}
            wrong = {}
            for name, row in (("no_mean_term", 0), ("no_variance_term", 1)):
                cut = coef.clone()
                cut[row] = 0.0
                wrong[name] = _rel_l2(bn.bn_relu_bwd_apply_plain(g, y, st_p, beta, cut), dy_p)
            res = {"phase": "bn_vs_plain", "dtype": dname, "shape_NHWC": list(shape),
                   "stats_vs_float64": stats_err, "const_channel_var_zero": tie,
                   "running_rel_l2": running, "fwd_max_ulp": fwd_ulp,
                   "fwd_unequal": fwd_unequal, "reduce_rel_l2": reduce_err,
                   "apply_max_ulp": apply_ulp, "apply_unequal": apply_unequal,
                   "op_rel_l2": op, "op_out_max_ulp": op_ulp, "op_out_unequal": op_unequal,
                   "wrong_backward_dy_rel_l2": wrong}
            if dtype == torch.bfloat16:
                res.update(_bn_times(bn, shape, y, g, gamma, beta, rm, rv, st_p, coef))
                for k in BN_KERNELS:
                    for key in ("ms", "plain_ms", "bound_ms"):
                        out[k][key] += layers * res[key][k]
                    out[k]["bound_by"].add(res["bound_by"][k])
                out["bn_stats"]["library_ms"] = ((out["bn_stats"]["library_ms"] or 0.0)
                                                 + layers * res["library_ms"]["bn_stats"])
                errs = {"bn_stats": float((st_k - st_p).abs().max()),
                        "bn_relu_fwd": float((fwd_k.float() - fwd_p.float()).abs().max()),
                        "bn_relu_bwd_reduce": max(float((a - b).abs().max())
                                                  for a, b in zip(red_k, red_p)),
                        "bn_relu_bwd_apply": float((dy_k.float() - dy_p.float()).abs().max())}
                for k, e in errs.items():
                    out[k]["max_abs_err"] = max(out[k]["max_abs_err"], e)
            emit(res, detail=True)
            acc = worst.setdefault(dname, {"stats_vs_float64": 0.0, "fwd_unequal": 0,
                                          "apply_unequal": 0, "reduce_rel_l2": 0.0,
                                          "op_rel_l2": 0.0, "min_wrong_dy_rel_l2": math.inf})
            acc["stats_vs_float64"] = max(acc["stats_vs_float64"], *stats_err["kernel"].values())
            acc["fwd_unequal"] += fwd_unequal
            acc["apply_unequal"] += apply_unequal
            acc["reduce_rel_l2"] = max(acc["reduce_rel_l2"], reduce_err)
            acc["op_rel_l2"] = max(acc["op_rel_l2"], *op.values())
            acc["min_wrong_dy_rel_l2"] = min(acc["min_wrong_dy_rel_l2"], *wrong.values())
            bad = []
            if max(stats_err["kernel"].values()) > BN_BOUNDS["stats"]:
                bad.append(f"statistics off float64 by {stats_err['kernel']}")
            if not tie:
                bad.append("the constant channel's variance is not exactly 0")
            if running > BN_BOUNDS["stats"]:
                bad.append(f"running statistics rel {running}")
            if fwd_unequal or apply_unequal:
                bad.append(f"fwd / apply not bit-exact on equal inputs ({fwd_unequal}, "
                           f"{apply_unequal} unequal)")
            if reduce_err > BN_BOUNDS["reduce"]:
                bad.append(f"reduce rel L2 {reduce_err}")
            if op["out"] > BN_BOUNDS["out"][dname]:
                bad.append(f"op output rel L2 {op['out']}")
            grad_bound = BN_BOUNDS["grad"][dname]
            if max(op[k] for k in ("dy", "dgamma", "dbeta")) > grad_bound:
                bad.append(f"op gradients {op}")
            if min(wrong.values()) <= grad_bound:
                bad.append(f"a wrong backward passes the dy bound {grad_bound}: {wrong}")
            if bad:
                fail("bn_vs_plain", f"{dname} {shape}: " + "; ".join(bad))
            del y, g, st_k, st_p, fwd_k, fwd_p, red_k, red_p, dy_k, dy_p, o_k, o_p, dy_ok, dy_op
            torch.cuda.empty_cache()
    for v in out.values():
        v["bound_by"] = "/".join(sorted(v["bound_by"]))
    emit({"phase": "bn_vs_plain", "shapes_NHWC": [list(sh) for sh in BN_SHAPES],
          "worst_over_shapes": worst, "bounds": BN_BOUNDS,
          "bf16_ms_per_train_step": {k: {key: v[key] for key in
                                         ("ms", "plain_ms", "bound_ms", "library_ms")}
                                     for k, v in out.items()}})
    return out


def _bn_times(bn, shape, y, g, gamma, beta, rm, rv, st, coef):
    """Median times of each kernel, its plain version and (for the
    statistics) ``torch.var_mean`` at one shape; three copies of y and g
    rotate so each call reads cold data, as the step does."""
    import torch

    ys = [y] + [y.clone(memory_format=torch.channels_last) for _ in range(2)]
    gs = [g] + [g.clone(memory_format=torch.channels_last) for _ in range(2)]
    rm, rv = rm.clone(), rv.clone()
    calls = {
        "bn_stats": (lambda f: lambda i: f(ys[i % 3], gamma, rm, rv),
                     bn.bn_stats, bn.bn_stats_plain),
        "bn_relu_fwd": (lambda f: lambda i: f(ys[i % 3], st, beta),
                        bn.bn_relu_fwd, bn.bn_relu_fwd_plain),
        "bn_relu_bwd_reduce": (lambda f: lambda i: f(gs[i % 3], ys[i % 3], st, beta, True),
                               bn.bn_relu_bwd_reduce, bn.bn_relu_bwd_reduce_plain),
        "bn_relu_bwd_apply": (lambda f: lambda i: f(gs[i % 3], ys[i % 3], st, beta, coef),
                              bn.bn_relu_bwd_apply, bn.bn_relu_bwd_apply_plain),
    }
    n_elem = math.prod(shape)
    C = shape[-1]
    res = {"ms": {}, "plain_ms": {}, "bound_ms": {}, "bound_by": {}, "library_ms": {}}
    for k, (call, kern, plain) in calls.items():
        res["ms"][k] = time_launches(call(kern))
        res["plain_ms"][k] = time_launches(call(plain), n=10, windows=3)
        elems, vecs = BN_TRAFFIC[k]
        res["bound_ms"][k], res["bound_by"][k] = bound_ms(
            elems * n_elem * y.element_size() + vecs * 4 * C, n_elem * BN_OPS_PER_ELEM[k])
        res["library_ms"][k] = None
    res["library_ms"]["bn_stats"] = time_launches(
        lambda i: torch.var_mean(ys[i % 3], dim=(0, 2, 3), unbiased=False))
    return res


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
    from tracknetv3_tpu_torch.data.dataset import HeatmapBatchLoader, build_split_index
    from tracknetv3_tpu_torch.ops import batchnorm as bn
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
    bn.LAUNCHES.update(dict.fromkeys(bn.LAUNCHES, 0))
    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):  # the CLI's own lines
        out1 = train_cli.main(common + ["--epochs", "1"])
        out2 = train_cli.main(common + ["--epochs", "2", "--resume_training"])
    torch.cuda.synchronize()
    launches = dict(wd.LAUNCHES)
    bn_launches = dict(bn.LAUNCHES)
    train_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()

    steps = out2["step"]
    hist = out1["history"] + out2["history"]
    losses = [v for h in hist for v in (h["train_loss"], h["val_loss"])]
    reloaded = [load_model_from_checkpoint(os.path.join(save_dir, f"TrackNet_{k}.pt"))[1]
                for k in ("best", "cur")]
    # 17 BatchNorm layers: each kernel once per layer per train step, and
    # the normalise once per layer per eval batch (one validation an epoch)
    eval_batches = len(hist) * len(HeatmapBatchLoader(
        build_split_index(data_dir, "val", L, L), "concat", B, data_dir=data_dir))
    want_bn = {k: BN_LAYERS * steps for k in bn.LAUNCHES}
    want_bn["bn_relu_fwd"] += BN_LAYERS * eval_batches
    emit({"phase": "slice", "train_steps": steps, "eval_batches": eval_batches,
          "launches": launches, "bn_launches": bn_launches,
          "epochs": [h["epoch"] for h in hist], "losses": losses,
          "val_res": hist[-1]["val_res"], "dataset_s": data_s, "train_s": train_s,
          "peak_mem_bytes": peak})
    if not steps or launches != {"fwd": steps, "bwd": steps}:
        fail("slice", f"launches {launches} != {steps} train steps")
    if bn_launches != want_bn:
        fail("slice", f"BatchNorm launches {bn_launches} != {want_bn} ({steps} train steps, "
             f"{eval_batches} eval batches, {BN_LAYERS} layers)")
    if [h["epoch"] for h in hist] != [0, 1]:
        fail("slice", "resume did not continue at epoch 2")
    if not all(math.isfinite(v) for v in losses):
        fail("slice", f"non-finite loss in {losses}")
    if any(pd.get("seq_len") != L for pd in reloaded):
        fail("slice", "checkpoint did not reload")
    if "accuracy" not in hist[-1]["val_res"]:
        fail("slice", "no val metrics")

    # Step time and peak memory of the full-width step on a fixed batch,
    # after warm-up, BatchNorm on the kernels.
    model = out2["model"]
    torch.cuda.reset_peak_memory_stats()
    step_ms = _time_train_steps(model, data_dir)
    step_peak = torch.cuda.max_memory_allocated()
    emit({"phase": "step_time", "config": "TrackNet seq_len 8 concat 288x512 batch 10 "
          "alpha 0.5 Adam bf16", "median_ms_per_step": statistics.median(step_ms),
          "ms_per_step": step_ms, "step_peak_mem_bytes": step_peak,
          "train_run_peak_mem_bytes": peak})
    return launches, bn_launches, statistics.median(step_ms), peak, model


def _first_batch(data_dir: str, dev):
    import torch

    from tracknetv3_tpu_torch.data.dataset import HeatmapBatchLoader, build_split_index

    index = build_split_index(data_dir, "train", L, 1)
    batch = next(iter(HeatmapBatchLoader(index, "concat", B, shuffle=True, seed=3,
                                         data_dir=data_dir)))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _time_train_steps(model, data_dir: str, n: int = 12):
    import torch

    return _time_steps(model, _first_batch(data_dir, torch.device("cuda")), 0.5, n)[0]


# (loss relative error, worst relative L2 error of a parameter gradient) of
# one train step against the same step with one part swapped. float32: the
# kernel loss vs the plain loss (read 0 and 1.8e-5), and the BatchNorm
# kernels vs their plain versions (read 0 and 0). bfloat16, BatchNorm
# kernels vs plain: read 0 and 0, while the wrong backwards read a
# gradient error of 1.0 or more (PERF.md); each must fail the bound.
STEP_PARITY_BOUNDS = {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 1e-2)}


def _step(base, dtype, x, targets, loss_fn, bn_op):
    """Loss and parameter gradients of one train step of a copy of ``base``
    in working dtype ``dtype``, BatchNorm through ``bn_op``."""
    import torch

    from tracknetv3_tpu_torch.ops import batchnorm as bn
    from tracknetv3_tpu_torch.training.steps import _to_model_input

    model = copy.deepcopy(base).to(DEVICE, memory_format=torch.channels_last).train()
    model.dtype = dtype
    with mock.patch.object(bn, "bn_relu_train", bn_op):
        loss = loss_fn(model(_to_model_input(x)).movedim(1, -1), *targets)
        loss.backward()
    return float(loss.detach()), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _wrong_bn(row: int):
    """``bn_relu_train`` whose (plain) backward drops its mean term (row 0
    of the coefficients) or its variance term (row 1)."""
    from tracknetv3_tpu_torch.ops import batchnorm as bn

    def apply(g, y, st, bias, coef):
        cut = coef.clone()
        cut[row] = 0.0
        return bn.bn_relu_bwd_apply_plain(g, y, st, bias, cut)

    ops = bn.PLAIN_OPS._replace(bwd_apply=apply)
    return lambda *args: bn.bn_relu(*args, True, ops)


def phase_step_parity(data_dir: str):
    import torch

    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.ops import batchnorm as bn
    from tracknetv3_tpu_torch.ops import wbce_disk as wd
    from tracknetv3_tpu_torch.training.steps import (
        assemble_tracknet_inputs,
        sample_mixup_inputs,
        sample_mixup_params,
    )

    dev = torch.device("cuda")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    # no autotuning: it tried every float32 algorithm of every layer, 2.5 min
    torch.backends.cudnn.benchmark = False
    kernel_loss, plain_loss = wd.wbce_disk_loss, wd.wbce_disk_loss_plain
    runs = {
        "float32": {"kernel": (kernel_loss, bn.bn_relu_train),
                    "plain_loss": (plain_loss, bn.bn_relu_train),
                    "plain_bn": (kernel_loss, bn.bn_relu_train_plain)},
        "bfloat16": {"kernel": (kernel_loss, bn.bn_relu_train),
                     "plain_bn": (kernel_loss, bn.bn_relu_train_plain),
                     "no_mean_term": (kernel_loss, _wrong_bn(0)),
                     "no_variance_term": (kernel_loss, _wrong_bn(1))},
    }
    try:
        batch = _first_batch(data_dir, dev)
        perm, lam = (torch.from_numpy(a).to(dev)
                     for a in sample_mixup_params(np.random.default_rng(7), B, 0.5))
        x = sample_mixup_inputs(assemble_tracknet_inputs(batch, "concat"), perm, lam)
        targets = wd.pack_mixup_targets(batch["cxcy"], perm, lam)
        base = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(11),
                         dtype=torch.float32)
        for dname, variants in runs.items():
            out = {name: _step(base, getattr(torch, dname), x, targets, loss_fn, op)
                   for name, (loss_fn, op) in variants.items()}
            lk, gk = out.pop("kernel")
            loss_bound, grad_bound = STEP_PARITY_BOUNDS[dname]
            res = {}
            for name, (lv, gv) in out.items():
                grad_rel = {k: _rel_l2(gk[k], gv[k]) for k in gv}
                worst = max(grad_rel, key=grad_rel.get)
                res[name] = {"loss": lv, "loss_rel_err": abs(lk - lv) / abs(lv),
                             "grad_rel_l2_max": grad_rel[worst], "grad_rel_l2_worst_param": worst}
                res[name]["within_bounds"] = (res[name]["loss_rel_err"] <= loss_bound
                                              and grad_rel[worst] <= grad_bound)
            emit({"phase": "step_parity", "dtype": dname, "tf32": False, "loss_kernel": lk,
                  "loss_bound": loss_bound, "grad_bound": grad_bound, "vs": res})
            for name, r in res.items():
                if r["within_bounds"] == name.startswith("no_"):
                    fail("step_parity", f"{dname} vs {name}: {r} (bounds {loss_bound}, "
                         f"{grad_bound}; a wrong backward must fail them)")
            del out
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


# ---------------------------------------------------------------- copy kernels

PROBE_TILE = 8  # the halo / shift probes' row tile: windows start at rows 0, 8, 16, 24
SEG_WINDOWS = 5  # windows per segment of the segmented runs: 2 segments of 12 frames a batch
COPY_KERNELS = ("window_copy", "repeat_rows", "roll_cols")


def _bits_data(shape, dtype, seed: int, dev):
    """uint8: uniform bytes. bfloat16 / float32: unit normals with 1% of the
    words replaced by random bit patterns (NaNs with payloads, infinities,
    denormals) and -0.0, +inf and two NaNs of different payloads set."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    ints, bits = {torch.bfloat16: (torch.int16, 16), torch.float32: (torch.int32, 32)}[dtype]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    words = x.view(ints).view(-1)  # shares x's memory
    idx = torch.randint(0, words.numel(), (words.numel() // 100,), generator=g, device=dev)
    lo = -(2 ** (bits - 1))
    words[idx] = torch.randint(lo, -lo, (idx.numel(),), generator=g, device=dev).to(ints)
    for i, v in enumerate((0x8000, 0x7F80, 0x7FC1, 0xFF83)):
        v <<= bits - 16
        words[7 * i + 1] = v - 2 ** bits if v >= -lo else v
    return x


def _words(t):
    import torch

    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _unequal_words(a, b) -> int:
    """Elements of ``a`` whose bits differ from ``b``'s (-1: shape or dtype)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    return int((_words(a) != _words(b)).sum())


def _window_rows(starts, rows: int):
    """(n, rows) int64 row indices of the windows: what one indexing call takes."""
    import torch

    return starts.long()[:, None] + torch.arange(rows, device=starts.device)[None, :]


def _off_by_one(starts, rows: int, n_rows: int):
    return (starts + 1).clamp(max=n_rows - rows)


def _copy_cases(dev, sc=None):
    """The seven probes at the probe's shapes and the train path's copies at
    the README configuration's. Each case: the kernel's call, its plain
    version, one PyTorch call that computes the same (``library``), a wrong
    version that must differ, on an input made by ``make(seed)``; ``needed``
    counts the elements the call must read (for a gather: its distinct rows).
    ``sc``: the copy module whose kernels the cases call (this tree's by
    default)."""
    import torch

    if sc is None:
        from tracknetv3_tpu_torch.ops import shift_copy as sc

    bf16, f32, u8 = torch.bfloat16, torch.float32, torch.uint8
    Hp, Wp, Cp = 32, 256, 128  # the probes' tile
    tile = torch.arange(0, Hp, PROBE_TILE, dtype=torch.int32, device=dev)
    cases = []

    def add(name, kernel, probe, shape, dtype, call, plain, library, lib_name, wrong, wrong_name,
            needed=None):
        cases.append(dict(name=name, kernel=kernel, probe=probe, shape=shape, dtype=dtype,
                          call=call, plain=plain, library=library, library_name=lib_name,
                          wrong=wrong, wrong_name=wrong_name, needed=needed))

    def window_case(name, probe, shape, dtype, starts, rows, lib, lib_name, wrong=None,
                    wrong_name="a start off by one", flat=None, **kw):
        """``window_copy`` on ``flat(x)`` (x viewed as rows of the source)."""
        flat = flat or (lambda x: x)
        fshape = tuple(flat(torch.empty(shape, device="meta")).shape)
        n_rows = fshape[0]
        plain_kw = {k: v for k, v in kw.items() if k != "staged"}
        # the distinct source rows, and of each the columns and channels copied
        needed = (torch.unique(_window_rows(starts, rows)).numel() * math.prod(fshape[1:-2])
                  * kw.get("cols", fshape[-2]) * kw.get("chs", fshape[-1]))
        add(name, "window_copy", probe, shape, dtype,
            lambda x: sc.window_copy(flat(x), starts, rows, **kw),
            lambda x: sc.window_copy_plain(flat(x), starts, rows, **plain_kw),
            lib, lib_name,
            wrong or (lambda x: sc.window_copy_plain(
                flat(x), _off_by_one(starts, rows, n_rows), rows, **plain_kw)),
            wrong_name, needed)

    # ---- the probes (tools/probe_mosaic_caps.py)
    xs = (Hp, Wp + 8, Cp)
    tiled = lambda t: t.reshape((Hp // PROBE_TILE, PROBE_TILE) + tuple(t.shape[1:]))  # noqa: E731
    window_case("U1", "U1 leading-slice DMA", xs, bf16, tile, PROBE_TILE,
                lambda x: tiled(x.clone()), "clone")
    shifted = lambda x: tiled(x.narrow(1, 1, Wp).contiguous())  # noqa: E731
    window_case("U2", "U2 sublane-offset-1 DMA", xs, bf16, tile, PROBE_TILE, shifted,
                "narrow().contiguous()", col0=1, cols=Wp)
    window_case("U3", "U3 in-kernel sublane-offset slice", xs, bf16, tile, PROBE_TILE, shifted,
                "narrow().contiguous()",
                wrong=lambda x: sc.window_copy_plain(x, tile, PROBE_TILE, col0=0, cols=Wp),
                wrong_name="the unshifted tile", col0=1, cols=Wp, staged=True)
    upper = lambda x: tiled(x.narrow(2, 128, 128).contiguous())  # noqa: E731
    for name, staged in (("U4", True), ("U4_direct", False)):
        window_case(name, "U4 in-kernel lane-slice aligned", (Hp, Wp, 256), bf16, tile,
                    PROBE_TILE, upper, "narrow().contiguous()",
                    wrong=lambda x: sc.window_copy_plain(x, tile, PROBE_TILE, ch0=0, chs=128),
                    wrong_name="the lower channels", ch0=128, chs=128, staged=staged)
    add("U5", "repeat_rows", "U5 pltpu.repeat sublane x2", (Hp, Wp, Cp), bf16,
        lambda x: sc.repeat_rows(x, 2), lambda x: sc.repeat_rows_plain(x, 2),
        lambda x: x.repeat_interleave(2, dim=0), "repeat_interleave",
        lambda x: tiled(x).repeat(1, 2, 1, 1).reshape((2 * Hp, Wp, Cp)),
        "the tiled repeat of each 8-row tile")
    for name, dtype in (("U6", f32), ("U6_bf16", bf16)):
        add(name, "roll_cols", "U6 f32 sublane roll", (Hp, Wp, Cp), dtype,
            lambda x: sc.roll_cols(x, 1), lambda x: sc.roll_cols_plain(x, 1),
            lambda x: torch.roll(x, 1, dims=-2), "torch.roll",
            lambda x: torch.roll(x, -1, dims=-2), "a roll the other way")
    window_case("U7", "U7 rank4 sublane-offset DMA", (2,) + xs, bf16, tile, PROBE_TILE,
                lambda x: tiled(x[0].narrow(1, 1, Wp).contiguous()), "narrow().contiguous()",
                flat=lambda x: x.reshape((2 * Hp,) + xs[1:]), col0=1, cols=Wp)

    # ---- the train path (training/steps.assemble_tracknet_inputs), README configuration
    rng = np.random.default_rng(31)
    frame = (H, W, 3)
    span = SEG_WINDOWS + L - 1
    n_seg = B // SEG_WINDOWS
    seg_starts = (torch.arange(n_seg, device=dev)[:, None] * span
                  + torch.arange(SEG_WINDOWS, device=dev)[None, :]).reshape(-1)
    flat_segs = lambda x: x.reshape((n_seg * span,) + frame)  # noqa: E731
    seg_rows = _window_rows(seg_starts, L)
    window_case("segment_expand", None, (n_seg, span) + frame, u8, seg_starts, L,
                lambda x: flat_segs(x)[seg_rows], "advanced indexing", flat=flat_segs)
    add("median_repeat", "repeat_rows", None, (n_seg,) + frame, u8,
        lambda x: sc.repeat_rows(x, SEG_WINDOWS), lambda x: sc.repeat_rows_plain(x, SEG_WINDOWS),
        lambda x: x.repeat_interleave(SEG_WINDOWS, dim=0), "repeat_interleave",
        lambda x: x.repeat(SEG_WINDOWS, 1, 1, 1), "the tiled repeat")
    n_res = 160  # frames of the synthetic train split: 2 matches x 2 rallies x 40
    res_idx = torch.from_numpy(rng.integers(0, n_res, B * L).astype(np.int32)).to(dev)
    window_case("resident_gather", None, (n_res,) + frame, u8, res_idx, 1,
                lambda x: torch.index_select(x, 0, res_idx)[:, None], "index_select")
    med_idx = torch.from_numpy(rng.integers(0, 4, B).astype(np.int32)).to(dev)
    window_case("resident_median_gather", None, (4,) + frame, f32, med_idx, 1,
                lambda x: torch.index_select(x, 0, med_idx)[:, None], "index_select")
    pair = torch.from_numpy(rng.integers(0, L, (B, L, 2))).to(dev)
    flat_win = lambda x: x.reshape((B * L,) + frame)  # noqa: E731
    for k in (0, 1):
        starts = (torch.arange(B, device=dev)[:, None] * L + pair[..., k]).reshape(-1)
        window_case(f"blend_gather_{'ab'[k]}", None, (B, L) + frame, u8, starts, 1,
                    lambda x, starts=starts: torch.index_select(flat_win(x), 0, starts)[:, None],
                    "index_select", flat=flat_win)
    return cases


def phase_copy(baseline=None):
    """copy_vs_plain: the three copy kernels against their plain versions,
    bit for bit, at the probes' shapes and the train path's; wrong versions
    must differ; times beside the bytes bound and one PyTorch call. With
    ``baseline`` (another tree's ops modules), that tree's kernels too, bit
    for bit, and the two timed in turns: old, new, new, old."""
    import torch

    from tracknetv3_tpu_torch.ops import shift_copy as sc
    from tracknetv3_tpu_torch.training import steps

    dev = torch.device(DEVICE)
    rows = {}
    old_cases = _copy_cases(dev, baseline[0]) if baseline is not None else None
    for i, c in enumerate(_copy_cases(dev)):
        xs = [_bits_data(c["shape"], c["dtype"], 200 + 3 * i + k, dev) for k in range(3)]
        sc.LAST_PLAN = None
        got = c["call"](xs[0])
        plan = sc.LAST_PLAN  # the plan window_copy launched (None for the other kernels)
        want, lib, wrong = (c[f](xs[0]) for f in ("plain", "library", "wrong"))
        torch.cuda.synchronize()
        unequal = _unequal_words(got, want)
        lib_unequal = _unequal_words(got.reshape(lib.shape), lib)
        wrong_unequal = _unequal_words(got.reshape(wrong.shape), wrong)
        # beside the bit comparison, the measured max |got - want| where both are finite
        err = _bit_compare(got, want)[2] if got.shape == want.shape else float("inf")
        turns = None
        if old_cases is not None:
            old = old_cases[i]["call"]
            old_unequal = _unequal_words(old(xs[0]), got)
            if old_unequal:
                fail("copy_vs_plain", f"{c['name']}: {old_unequal} words differ from the "
                     "baseline tree's kernel")
            new = lambda j: c["call"](xs[j % 3])  # noqa: E731
            turns = [time_launches(lambda j: old(xs[j % 3])), time_launches(new),
                     time_launches(new), time_launches(lambda j: old(xs[j % 3]))]
            if plan is not None:
                host = [host_us_per_call(lambda j: old(xs[j % 3])), host_us_per_call(new),
                        host_us_per_call(new), host_us_per_call(lambda j: old(xs[j % 3]))]
        ms = time_launches(lambda j: c["call"](xs[j % 3]))
        plain_ms = time_launches(lambda j: c["plain"](xs[j % 3]))
        lib_ms = time_launches(lambda j: c["library"](xs[j % 3]))
        n_in = math.prod(c["shape"]) if c["needed"] is None else c["needed"]
        n_bytes = (n_in + got.numel()) * got.element_size()
        b_ms, b_by = bound_ms(n_bytes, 0)
        special = 0 if c["dtype"] == torch.uint8 else int((~torch.isfinite(got)).sum())
        rows[c["name"]] = r = {
            "phase": "copy_vs_plain", "case": c["name"], "kernel": c["kernel"],
            "probe": c["probe"], "dtype": str(c["dtype"]).split(".")[-1],
            "in_shape": list(c["shape"]), "out_shape": list(got.shape),
            "unequal_words": unequal, "max_abs_err": err, "library": c["library_name"],
            "library_unequal_words": lib_unequal, "wrong": c["wrong_name"],
            "wrong_unequal_words": wrong_unequal, "nan_or_inf_copied": special,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "mb_moved": n_bytes / 1e6}
        if plan is not None:
            r["route"] = plan.route
        if turns is not None:
            r["turns_old_new_new_old_ms"] = turns
            r["earlier_ms"] = statistics.mean(turns[0::3])
            r["new_in_turns_ms"] = statistics.mean(turns[1:3])
            if plan is not None:
                r["host_us_per_call_old_new_new_old"] = host
        emit(r, detail=True)
        if unequal or lib_unequal:
            fail("copy_vs_plain", f"{c['name']}: {unequal} words differ from the plain version, "
                 f"{lib_unequal} from {c['library_name']}")
        if wrong_unequal == 0:
            fail("copy_vs_plain", f"{c['name']}: {c['wrong_name']} passes the comparison")
        if c["dtype"] != torch.uint8 and special == 0:
            fail("copy_vs_plain", f"{c['name']}: no NaN or inf reached the output")
        del xs, got, want, lib, wrong
    # the step's own helpers reach the same kernels with tables they build themselves
    segs = _bits_data((B // SEG_WINDOWS, SEG_WINDOWS + L - 1, H, W, 3), torch.uint8, 290, dev)
    want = torch.stack([segs[s, j : j + L] for s in range(segs.shape[0])
                        for j in range(SEG_WINDOWS)])
    helper_unequal = _unequal_words(steps._expand_segments(segs, L), want)
    if helper_unequal:
        fail("copy_vs_plain", f"_expand_segments: {helper_unequal} words differ from slicing")
    emit({"phase": "copy_vs_plain", "what": "bit-equal to the plain version and to one PyTorch "
          "call; each wrong version differs; [ms, bound_ms, plain_ms, library_ms]",
          "cases": {k: [round(r[key], 5) for key in ("ms", "bound_ms", "plain_ms", "library_ms")]
                    for k, r in rows.items()},
          "routes": {k: r["route"] for k, r in rows.items() if "route" in r},
          "earlier_ms": ({k: round(r["earlier_ms"], 5) for k, r in rows.items()}
                         if baseline is not None else "not measured"),
          "expand_segments_helper_unequal_words": helper_unequal})
    # the kernels' line: each kernel at the train path's shape (the roll at the probe's)
    at = {"window_copy": "segment_expand", "repeat_rows": "median_repeat", "roll_cols": "U6"}
    return {k: {"at": f"copy_vs_plain case {v}",
                **{key: rows[v][key] for key in ("max_abs_err", "unequal_words", "ms", "plain_ms",
                                                 "bound_ms", "bound_by", "library_ms")}}
            for k, v in at.items()}


# (name, flags beyond the common ones, (window_copy, repeat_rows) launches per
# train step and per eval batch, K1 / K2 launches per train step): segmented
# batches expand once and repeat the median once; a frame-mixup step gathers
# the blend's two operands (with sample mixup too it composes materialised
# labels, so the two-disk loss kernels rest); a resident step gathers frames
# and medians, in training and in validation
SEG_RUNS = (
    ("segment_windows", ["--segment_windows", str(SEG_WINDOWS), "--alpha", "0.5"], (1, 1), (0, 0), 1),
    ("frame_alpha", ["--frame_alpha", "0.5", "--alpha", "-1"], (2, 0), (0, 0), 1),
    ("frame_alpha+alpha", ["--frame_alpha", "0.5", "--alpha", "0.5"], (2, 0), (0, 0), 0),
    ("resident_frames", ["--resident_frames", "--alpha", "0.5"], (2, 0), (2, 0), 1),
)


def _device_batch(batch, dev):
    import torch

    return {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
            for k, v in batch.items()}


def _seg_batches(data_dir: str, dev):
    """The first batch (seed 3) of each loader mode, on the host."""
    from tracknetv3_tpu_torch.data.dataset import (
        HeatmapBatchLoader,
        ResidentHeatmapLoader,
        build_split_index,
    )

    index = build_split_index(data_dir, "train", L, 1)
    kw = dict(shuffle=True, seed=3, data_dir=data_dir)
    loaders = {
        "plain": HeatmapBatchLoader(index, "concat", B, **kw),
        "segment_windows": HeatmapBatchLoader(index, "concat", B, segment_windows=SEG_WINDOWS, **kw),
        "frame_alpha": HeatmapBatchLoader(index, "concat", B, frame_alpha=0.5, **kw),
        "resident_frames": ResidentHeatmapLoader(index, "concat", B, device=dev, **kw),
    }
    return {k: next(iter(v)) for k, v in loaders.items()}


def phase_seg_train(tmp: str, model):
    """seg_train: the train CLI with segmented batches, frame mixup (alone and
    with sample mixup) and device-resident frames, one epoch each; then ms per
    step, peak memory and host bytes shipped per step on a fixed batch of each
    kind, beside the plain batch's."""
    import torch

    from tracknetv3_tpu_torch import train as train_cli
    from tracknetv3_tpu_torch.data.dataset import HeatmapBatchLoader, build_split_index
    from tracknetv3_tpu_torch.ops import shift_copy as sc
    from tracknetv3_tpu_torch.ops import wbce_disk as wd
    from tracknetv3_tpu_torch.training.loop import _DEVICE_KEYS

    dev = torch.device(DEVICE)
    data_dir = os.path.join(tmp, "data")
    eval_batches = len(HeatmapBatchLoader(build_split_index(data_dir, "val", L, L), "concat", B,
                                          data_dir=data_dir))
    total = dict.fromkeys(sc.LAUNCHES, 0)
    runs = {}
    for name, flags, per_step, per_eval, loss_kernels in SEG_RUNS:
        sc.LAUNCHES.update(dict.fromkeys(sc.LAUNCHES, 0))  # counts of this run only
        wd.LAUNCHES.update(fwd=0, bwd=0)
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):  # the CLI's own lines
            out = train_cli.main(["--seq_len", str(L), "--bg_mode", "concat",
                                  "--batch_size", str(B), "--data_dir", data_dir,
                                  "--epochs", "1",
                                  "--save_dir", os.path.join(tmp, f"exp_{name}")] + flags)
        torch.cuda.synchronize()
        launches, k_launches = dict(sc.LAUNCHES), dict(wd.LAUNCHES)
        steps, (h,) = out["step"], out["history"]
        want = {"window_copy": per_step[0] * steps + per_eval[0] * eval_batches,
                "repeat_rows": per_step[1] * steps + per_eval[1] * eval_batches, "roll_cols": 0}
        runs[name] = {"train_steps": steps, "eval_batches": eval_batches, "launches": launches,
                      "loss_kernel_launches": k_launches, "train_loss": h["train_loss"],
                      "val_loss": h["val_loss"], "seconds": round(time.time() - t0, 2)}
        if not steps or launches != want:
            fail("seg_train", f"{name}: copy launches {launches} != {want} ({steps} train steps, "
                 f"{eval_batches} eval batches)")
        if k_launches != {"fwd": loss_kernels * steps, "bwd": loss_kernels * steps}:
            fail("seg_train", f"{name}: loss kernel launches {k_launches} in {steps} steps")
        if not (math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"])
                and "accuracy" in h["val_res"]):
            fail("seg_train", f"{name}: {h}")
        for k, v in launches.items():
            total[k] += v
    emit({"phase": "seg_train", "config": f"TrackNet seq_len {L} concat {H}x{W} batch {B} bf16, "
          f"one epoch each through the train CLI", "runs": runs, "copy_launches_total": total})

    # a fixed batch of each kind, in turns: plain first and last
    batches = _seg_batches(data_dir, dev)
    order = (("plain", "plain", 0.5), ("segment_windows", "segment_windows", 0.5),
             ("frame_alpha", "frame_alpha", -1.0), ("frame_alpha+alpha", "frame_alpha", 0.5),
             ("resident_frames", "resident_frames", 0.5), ("plain_again", "plain", 0.5))
    times = {}
    for name, kind, alpha in order:
        host = batches[kind]
        shipped = sum(v.nbytes for k, v in host.items()
                      if k in _DEVICE_KEYS and isinstance(v, np.ndarray))
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses = _time_steps(model, _device_batch(host, dev), alpha)
        times[name] = {"median_ms": statistics.median(step_ms), "min_ms": min(step_ms),
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "host_bytes_shipped": shipped,
                       "loss_first_last": [losses[0], losses[-1]]}
        if not all(math.isfinite(v) for v in losses) or min(losses[-3:]) > 1.1 * losses[0]:
            fail("seg_step_time", f"{name}: the loss on a fixed batch went {losses}")
    emit({"phase": "seg_step_time", "what": "per step: 10 steps after 2 warm-up on one fixed "
          "batch of each kind, host clock around synchronize", "kinds": times})
    return total


def _time_steps(model, batch, alpha: float, n: int = 12):
    """(ms of each step after 2 warm-up, the loss of every step) of ``n``
    train steps on one device batch, a new Adam each time."""
    import torch

    from tracknetv3_tpu_torch.training.optim import build_optimizer
    from tracknetv3_tpu_torch.training.steps import make_tracknet_train_step, sample_mixup_params

    dev = torch.device(DEVICE)
    opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
    step = make_tracknet_train_step(model, opt, "concat", alpha, sched)
    mix = ()
    if alpha > 0:
        mix = tuple(torch.from_numpy(a).to(dev)
                    for a in sample_mixup_params(np.random.default_rng(5), B, alpha))
    times, losses = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch, i, *mix)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return times[2:], losses


def _expanded_plain(batch):
    """The plain batch that holds the windows of a segmented or resident
    batch, by torch indexing (no kernel of the port)."""
    import torch

    out = {"cxcy": batch["cxcy"]}
    if "seg_rgb" in batch:
        segs = batch["seg_rgb"]
        seg = segs.shape[1] - L + 1
        out["rgb"] = segs[:, _window_rows(torch.arange(seg, device=segs.device), L)].flatten(0, 1)
        out["median"] = batch["median"].repeat_interleave(seg, dim=0)
    else:
        out["rgb"] = batch["res_rgb_buf"][batch["res_idx"].long()]
        out["median"] = batch["res_median_buf"][batch["res_median_idx"].long()]
    return out


def phase_seg_parity(data_dir: str):
    """seg_parity: one float32 train step (TF32 off, deterministic cuDNN, no
    autotuning) from the same weights on a segmented batch, on a resident
    batch, and on the plain batch holding the same windows: the assembled
    input bit-equal; loss and gradients bit-equal, or within the float32
    bounds of ``step_parity`` where a plain step differs from itself."""
    import torch

    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.training.optim import build_optimizer
    from tracknetv3_tpu_torch.training.steps import (
        assemble_tracknet_inputs,
        make_tracknet_train_step,
        sample_mixup_params,
    )

    dev = torch.device(DEVICE)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    base = get_model("TrackNet", L, "concat", generator=torch.Generator().manual_seed(11),
                     dtype=torch.float32)
    perm, lam = (torch.from_numpy(a).to(dev)
                 for a in sample_mixup_params(np.random.default_rng(7), B, 0.5))

    def one_step(batch):
        model = copy.deepcopy(base).to(dev, memory_format=torch.channels_last)
        opt, sched = build_optimizer("Adam", model.parameters(), 1e-3)
        loss = make_tracknet_train_step(model, opt, "concat", 0.5, sched)(batch, 0, perm, lam)
        return float(loss), {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    def versus(a, b):
        (la, ga), (lb, gb) = a, b
        rel = {k: _rel_l2(ga[k], gb[k]) for k in gb}
        return {"loss": la, "loss_rel_err": abs(la - lb) / abs(lb),
                "grad_rel_l2_max": max(rel.values()),
                "bit_equal": la == lb and all(torch.equal(ga[k], gb[k]) for k in gb)}

    loss_bound, grad_bound = STEP_PARITY_BOUNDS["float32"]
    try:
        host = _seg_batches(data_dir, dev)
        res = {}
        for kind in ("segment_windows", "resident_frames"):
            batch = _device_batch(host[kind], dev)
            plain = _expanded_plain(batch)
            x_unequal = _unequal_words(assemble_tracknet_inputs(batch, "concat"),
                                       assemble_tracknet_inputs(plain, "concat"))
            ref = one_step(plain)
            res[kind] = {"x_unequal_words": x_unequal, "vs_plain": versus(one_step(batch), ref),
                         "plain_vs_itself": versus(one_step(plain), ref)}
        emit({"phase": "seg_parity", "dtype": "float32", "tf32": False,
              "cudnn": "deterministic, no autotuning", "loss_bound": loss_bound,
              "grad_bound": grad_bound, "kinds": res})
        for kind, r in res.items():
            v = r["vs_plain"]
            if r["x_unequal_words"]:
                fail("seg_parity", f"{kind}: {r['x_unequal_words']} elements of the assembled "
                     "input differ from the plain batch's")
            if not (v["bit_equal"] or (v["loss_rel_err"] <= loss_bound
                                       and v["grad_rel_l2_max"] <= grad_bound)):
                fail("seg_parity", f"{kind}: {v} (bounds {loss_bound}, {grad_bound})")
            if not v["bit_equal"] and r["plain_vs_itself"]["bit_equal"]:
                fail("seg_parity", f"{kind}: equal inputs, a plain step that repeats bit for "
                     f"bit, and yet {v}")
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


# ---------------------------------------------------------------- serving

SERVE_T = 480  # frames of the synthetic video
# (conv_backend, batch size, frames served): each route at the predict CLI's
# default batch and bench.py's, over the whole video
SERVE_RUNS = (("cudnn", 16, SERVE_T), ("cudnn", 120, SERVE_T), ("hand_k3c", 16, SERVE_T),
              ("hand_k3c", 120, SERVE_T), ("hand_9tap", 16, SERVE_T), ("hand_9tap", 120, SERVE_T))
# (max, mean) |dp| of the folded forward vs the unfolded TrackNet, on the
# checkpoint of deterministic_checkpoint, which repeats from run to run. bf16:
# the sound forward read 0.0127 max (the hand routes 0.0134) and every wrong
# forward at least 0.237 (pool1_stride2 0.249, up3_tiled 0.291, pool3_stride2
# 0.239, up1_tiled 0.237) on an H100 (PERF.md): the bound sits between.
# float32: the bounds of tests/test_torch_fused_forward.py
SERVE_PARITY_BOUNDS = {"bfloat16": (3e-2, 1e-3), "float32": (1e-5, 1e-6)}
PARITY_STARTS = (0, 232, 456)  # first window of each 16-window chunk of serve_parity
# each must fail the bf16 bound; bias_after_cast, a rounding, is read beside them
WRONG_FORWARDS = ("pool1_stride2", "up3_tiled", "pool3_stride2", "up1_tiled")
HAND_BACKENDS = ("hand_k3c", "hand_9tap")  # the 3x3 convs on the kernels of conv3x3.cu
# NHWC input shape of each pool and upsample call of one forward at batch 16
POOL_SHAPES = ((16, 288, 512, 64), (16, 144, 256, 128), (16, 72, 128, 256))
UP_SHAPES = ((16, 36, 64, 512), (16, 72, 128, 256), (16, 144, 256, 128))


def _special_bf16(shape, seed: int, dev):
    """Random bf16 NHWC data with 32 NaN and 32 -inf entries, as the NCHW
    view (channels_last memory) that the kernels take."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    flat = x.view(-1)
    idx = torch.randint(0, flat.numel(), (64,), generator=g, device=dev)
    flat[idx[:32]] = float("nan")
    flat[idx[32:]] = float("-inf")
    return x.permute(0, 3, 1, 2)


def _bit_compare(a, b):
    """(NaN positions equal, count of other unequal entries, max |a - b| over
    entries finite in both)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    both = ~na & ~nb
    unequal = int(((a != b) & both).sum())
    finite = both & torch.isfinite(a) & torch.isfinite(b)
    err = float((a.float() - b.float()).abs()[finite].max()) if bool(finite.any()) else 0.0
    return bool(torch.equal(na, nb)), unequal, err


def phase_pool_up():
    import torch

    from tracknetv3_tpu_torch.ops import pool_up2x as pu

    dev = torch.device(DEVICE)
    kernels = (
        # name, kernel, plain, input shapes, output/input elements, ops per output
        ("maxpool2x2", pu.maxpool2x2, pu.maxpool2x2_plain, POOL_SHAPES, 0.25, 3),
        ("up2x_nearest", pu.up2x_nearest, pu.up2x_nearest_plain, UP_SHAPES, 4, 0),
    )
    totals = {}
    for name, kern, plain, shapes, ratio, ops in kernels:
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0, "bound_by": []}
        for i, shape in enumerate(shapes):
            # three copies so each timed call reads cold data, as in the forward
            xs = [_special_bf16(shape, 100 * i + k, dev) for k in range(3)]
            got, want = kern(xs[0]), plain(xs[0])
            torch.cuda.synchronize()
            same_nan, unequal, err = _bit_compare(got, want)
            layout = got.is_contiguous(memory_format=torch.channels_last)
            ms = time_launches(lambda j: kern(xs[j % 3]))
            plain_ms = time_launches(lambda j: plain(xs[j % 3]))
            n_in = math.prod(shape)
            n_out = int(n_in * ratio)
            b_ms, b_by = bound_ms(2 * (n_in + n_out), ops * n_out)
            emit({"phase": "pool_up_vs_plain", "kernel": name, "shape_NHWC": list(shape),
                  "nan_positions_equal": same_nan, "unequal": unequal, "max_abs_err": err,
                  "channels_last_out": layout, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "mb_moved": 2 * (n_in + n_out) / 1e6},
                 detail=True)
            if not (same_nan and unequal == 0 and err == 0.0 and layout
                    and tuple(got.shape) == tuple(want.shape)):
                fail("pool_up_vs_plain", f"{name} at {shape}: nan_equal={same_nan} "
                     f"unequal={unequal} err={err} channels_last={layout}")
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += b_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["bound_by"].append(b_by)
            del xs, got, want
        totals[name] = tot
    emit({"phase": "pool_up_vs_plain", "what": "the three calls of one serving forward at "
          "batch 16, bf16 with NaN and -inf, ms summed; every shape bit-exact",
          "kernels": {k: {key: v[key] for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
                      for k, v in totals.items()}})
    return totals


# ---------------------------------------------------------------- 3x3 conv

# (H, W, Ci, Co) of each distinct 3x3 conv of one serving forward, and how
# many of its 17 convs have it (blocks of 2/2/3/3/3/2/2; an up block's first
# conv reads the concat [up2x(x), skip])
CONV_SHAPES = {(288, 512, 27, 64): 1, (288, 512, 64, 64): 2, (288, 512, 192, 64): 1,
               (144, 256, 64, 128): 1, (144, 256, 128, 128): 2, (144, 256, 384, 128): 1,
               (72, 128, 128, 256): 1, (72, 128, 256, 256): 4, (72, 128, 768, 256): 1,
               (36, 64, 256, 512): 1, (36, 64, 512, 512): 2}
CONV_LAYERS = sum(CONV_SHAPES.values())
CONV_BATCH = 16
# N, H, W, Ci, Co where no tile divides H or W: BN = 128, and BN = 64 (the 9tap
# kernel's M = 256 tile) with a partial last input-channel chunk
CONV_ODD_SHAPES = ((3, 37, 61, 96, 128), (3, 37, 61, 40, 64))
CONV_VARIANTS = ("k3c", "9tap")
# Kernel vs plain in bfloat16 spacings at max(|a|, |b|, RMS / 8)
# (``bf16_ulps_apart``): both round one float32 sum of the same terms once,
# so they are equal or neighbours: the kernels read exactly 1.0 at every
# shape on the card. The bias added after the cast reads 4.25 or more and
# the other wrong convs 255 (PERF.md); the bound sits between.
CONV_ULPS_BOUND = 1.0
CONV_FLOOR_OF_RMS = 0.125
CONV_WRONG = ("tap_dropped", "dx_mirrored", "halo_not_zero", "bias_after_cast",
              "last_chunk_dropped")
ABLATE_SHAPE = (24, 72, 128, 256, 256)  # the ablation probe's: N, H, W, Ci, Co


def _conv_data(N, H, W, Ci, Co, seed: int, dev):
    """One layer's operands: x (NCHW view of channels_last bf16, channels
    padded with zeros to the kernels' multiple) of unit normals with 5% exact
    zeros, one NaN and one inf in sample 0; a He-scaled HWIO kernel, so that
    outputs have an RMS near 1; a bias of spread 0.5, so that the ReLU cuts
    about half and sums cancel against it."""
    import torch

    from tracknetv3_tpu_torch.ops import conv3x3 as c3

    g = torch.Generator(device=dev).manual_seed(seed)
    cp = c3.padded_channels(Ci)
    x = torch.zeros((N, H, W, cp), dtype=torch.bfloat16, device=dev)
    v = torch.randn((N, H, W, Ci), generator=g, device=dev)
    v = v.masked_fill(torch.rand((N, H, W, Ci), generator=g, device=dev) < 0.05, 0.0)
    x[..., :Ci] = v.to(torch.bfloat16)
    del v
    x[0, H // 3, W // 3, Ci // 2] = float("nan")
    x[0, (2 * H) // 3, (2 * W) // 3, Ci // 3] = float("inf")
    k = torch.randn((3, 3, Ci, Co), generator=g, device=dev) * math.sqrt(2.0 / (9 * Ci))
    bias = 0.5 * torch.randn((Co,), generator=g, device=dev)
    return x.permute(0, 3, 1, 2), k, bias


def _conv_f32(x_f32, w_hwio_f32, padding: int = 1):
    """float32 conv of NCHW ``x`` with an HWIO kernel by PyTorch's own
    (non-cuDNN) convolution, as the plain version runs it."""
    import torch
    import torch.nn.functional as F

    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(x_f32, w_hwio_f32.permute(3, 2, 0, 1), padding=padding)


def _wrong_conv(name: str, x, w_hwio, bias):
    """The conv + bias + ReLU with one deliberate fault, in float32 torch
    ops: the (dy 2, dx 0) tap dropped, the kernel mirrored in dx, the halo
    filled with the edge pixel instead of zero, the bias added after the
    cast to bfloat16, or the last chunk of ``CK`` input channels dropped (an
    off-by-one in the ring's drain or an mbarrier phase fault)."""
    import torch
    import torch.nn.functional as F

    from tracknetv3_tpu_torch.ops.conv3x3 import CK

    xf, w = x.float(), w_hwio.to(torch.bfloat16).float()
    w = F.pad(w, (0, 0, 0, x.shape[1] - w.shape[2]))  # the input's zero channels
    if name == "tap_dropped":
        w = w.clone()
        w[2, 0] = 0.0
    elif name == "dx_mirrored":
        w = w.flip(1)
    elif name == "last_chunk_dropped":
        w = w.clone()
        w[:, :, (x.shape[1] - 1) // CK * CK:] = 0.0
    if name == "halo_not_zero":
        y = _conv_f32(F.pad(xf, (1, 1, 1, 1), mode="replicate"), w, padding=0)
    else:
        y = _conv_f32(xf, w)
    if name == "bias_after_cast":
        y = y.to(torch.bfloat16).float()
    y = torch.maximum(y + bias.reshape(1, -1, 1, 1), torch.zeros((), device=y.device))
    return y.to(torch.bfloat16)


def _conv_compare(got, want, x):
    """Kernel output vs plain: (NaN positions equal, and equal to the 3x3
    neighbourhood of the input's NaN; inf positions equal; bfloat16 spacings
    apart; share of unequal finite entries; max |a - b| over finite ones)."""
    import torch
    import torch.nn.functional as F

    from tracknetv3_tpu_torch.ops.conv3x3 import bf16_ulps_apart

    nan_in = torch.isnan(x).any(dim=1, keepdim=True).float()
    nan_want = F.max_pool2d(nan_in, 3, stride=1, padding=1).bool().expand_as(got)
    ng, nw = torch.isnan(got), torch.isnan(want)
    ig, iw = torch.isinf(got), torch.isinf(want)
    finite = torch.isfinite(got) & torch.isfinite(want)
    wf = want.float()
    rms = float(wf[finite].square().mean().sqrt())
    return {
        "nan_positions_equal": bool(torch.equal(ng, nw)),
        "nan_is_3x3_neighbourhood": bool(torch.equal(ng, nan_want)),
        "inf_positions_equal": bool(torch.equal(ig, iw)
                                    and torch.equal(got[ig] > 0, want[ig] > 0)),
        "nan_entries": int(ng.sum()), "inf_entries": int(ig.sum()),
        "ulps_apart": bf16_ulps_apart(got, want, CONV_FLOOR_OF_RMS * rms),
        "unequal_share": float(((got != want) & finite).float().mean()),
        "max_abs_err": float((got.float() - wf).abs()[finite].max()),
        "out_rms": rms,
    }


def _conv_sound(r) -> bool:
    return (r["nan_positions_equal"] and r["nan_is_3x3_neighbourhood"]
            and r["inf_positions_equal"] and r["ulps_apart"] <= CONV_ULPS_BOUND)


def _conv_check_shape(c3, shape, seed: int, dev, timed: bool):
    """conv_vs_plain at one (N, H, W, Ci, Co); times too when ``timed``."""
    import torch
    import torch.nn.functional as F

    from tracknetv3_tpu_torch.models import fused_forward as ff

    N, H, W, Ci, Co = shape
    x, k, bias = _conv_data(N, H, W, Ci, Co, seed, dev)
    packed = c3.pack_weights(k, torch.bfloat16, device=dev)
    res = {"phase": "conv_vs_plain", "shape_NHWC": [N, H, W, Ci], "Co": Co,
           "padded_Ci": x.shape[1], "bound_ulps": CONV_ULPS_BOUND}
    bad = []
    for label, b, relu in (("epilogue", bias, True), ("bare", None, False)):
        want = c3.conv3x3_bias_relu_plain(x, packed, b, relu=relu)
        outs = {v: c3.conv3x3_bias_relu(x, packed, b, variant=v, relu=relu)
                for v in CONV_VARIANTS}
        torch.cuda.synchronize()
        res[label] = {v: _conv_compare(o, want, x) for v, o in outs.items()}
        res[label]["k3c_equals_9tap"] = bool(torch.equal(
            outs["k3c"].view(torch.int16), outs["9tap"].view(torch.int16)))
        between = _conv_compare(outs["k3c"], outs["9tap"], x)
        res[label]["k3c_vs_9tap_ulps"] = between["ulps_apart"]
        if not _conv_sound(between):
            bad.append(f"k3c and 9tap {label} differ: {between}")
        for v, o in outs.items():
            if not (_conv_sound(res[label][v])
                    and o.is_contiguous(memory_format=torch.channels_last)
                    and tuple(o.shape) == (N, Co, H, W)):
                bad.append(f"{v} {label}: {res[label][v]}")
        if label == "epilogue":
            # the wrong convs on two samples that hold no NaN or inf
            lo = min(2, N - 1)
            xs, ws = x[lo : lo + 2], want[lo : lo + 2].float()
            floor = CONV_FLOOR_OF_RMS * float(ws.square().mean().sqrt())
            res["wrong_ulps_apart"] = {
                name: c3.bf16_ulps_apart(_wrong_conv(name, xs, k, bias), ws, floor)
                for name in CONV_WRONG}
            passed = [n for n, u in res["wrong_ulps_apart"].items() if u <= CONV_ULPS_BOUND]
            if passed:
                bad.append(f"the bound passes the wrong convs {passed}")
        del want, outs
    if timed:
        # three copies of x rotate so that each call reads cold data
        xs = [x] + [x.clone(memory_format=torch.channels_last) for _ in range(2)]
        ms = {v: time_launches(lambda i, v=v: c3.conv3x3_bias_relu(
            xs[i % 3], packed, bias, variant=v), n=10, windows=3) for v in CONV_VARIANTS}
        plain_ms = time_launches(lambda i: c3.conv3x3_bias_relu_plain(xs[i % 3], packed, bias),
                                 n=2, windows=3)
        # today's route: cuDNN on the unpadded bf16 channels_last operands,
        # alone and with the torch bias + ReLU + cast passes
        w = k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        b4 = bias.reshape(1, -1, 1, 1)
        xc = [t[:, :Ci].contiguous(memory_format=torch.channels_last) for t in xs]
        cudnn_ms = time_launches(lambda i: F.conv2d(xc[i % 3], w, padding=1), n=10, windows=3)
        cudnn_epi_ms = time_launches(lambda i: ff._conv_relu(xc[i % 3], w, b4), n=10, windows=3)
        flops = 2 * N * H * W * 9 * Ci * Co
        n_bytes = 2 * (N * H * W * (Ci + Co) + 9 * Ci * Co) + 4 * Co
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS)
        res.update({"ms": ms, "plain_ms": plain_ms, "cudnn_ms": cudnn_ms,
                    "cudnn_with_epilogue_ms": cudnn_epi_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "gflop": flops / 1e9,
                    "tflops": {v: flops / t / 1e9 for v, t in ms.items()}})
    emit(res, detail=True)
    if bad:
        fail("conv_vs_plain", f"{shape}: " + "; ".join(bad))
    return res


def phase_conv():
    """conv_vs_plain at the serving forward's shapes (timed) and at one odd
    shape; returns per kernel the sums over the 17 convs of one forward."""
    import torch

    from tracknetv3_tpu_torch.ops import conv3x3 as c3

    dev = torch.device(DEVICE)
    torch.backends.cudnn.benchmark = True  # the yardstick picks its fastest algorithms
    tot = {v: {"ms": 0.0, "max_abs_err": 0.0} for v in CONV_VARIANTS}
    shared = {"plain_ms": 0.0, "cudnn_ms": 0.0, "cudnn_with_epilogue_ms": 0.0,
              "bound_ms": 0.0, "gflop": 0.0}
    bound_by = {"bytes": 0.0, "operations": 0.0}  # ms of the summed bound under each
    checked, per_shape = [], []
    for i, ((H, W, Ci, Co), layers) in enumerate(CONV_SHAPES.items()):
        r = _conv_check_shape(c3, (CONV_BATCH, H, W, Ci, Co), 40 + i, dev, timed=True)
        checked.append(r)
        per_shape.append({"H": H, "W": W, "Ci": Ci, "Co": Co, "layers": layers,
                          **{f"{v}_ms": r["ms"][v] for v in CONV_VARIANTS},
                          "cudnn_ms": r["cudnn_ms"], "bound_ms": r["bound_ms"],
                          "share_of_bound": {v: r["bound_ms"] / r["ms"][v]
                                             for v in CONV_VARIANTS}})
        for v in CONV_VARIANTS:
            tot[v]["ms"] += layers * r["ms"][v]
            tot[v]["max_abs_err"] = max(tot[v]["max_abs_err"], r["epilogue"][v]["max_abs_err"],
                                        r["bare"][v]["max_abs_err"])
        for key in shared:
            shared[key] += layers * r[key]
        bound_by[r["bound_by"]] += layers * r["bound_ms"]
        torch.cuda.empty_cache()
    for i, shape in enumerate(CONV_ODD_SHAPES):
        checked.append(_conv_check_shape(c3, shape, 60 + i, dev, timed=False))
    emit({"phase": "conv_vs_plain", "shapes": len(checked), "bound_ulps": CONV_ULPS_BOUND,
          "worst_ulps_apart": max(r[e][v]["ulps_apart"] for r in checked
                                  for e in ("epilogue", "bare") for v in CONV_VARIANTS),
          "max_unequal_share": max(r[e][v]["unequal_share"] for r in checked
                                   for e in ("epilogue", "bare") for v in CONV_VARIANTS),
          "k3c_equals_9tap_everywhere": all(r[e]["k3c_equals_9tap"] for r in checked
                                            for e in ("epilogue", "bare")),
          "worst_k3c_vs_9tap_ulps": max(r[e]["k3c_vs_9tap_ulps"] for r in checked
                                        for e in ("epilogue", "bare")),
          "min_wrong_ulps_apart": {n: min(r["wrong_ulps_apart"][n] for r in checked)
                                   for n in CONV_WRONG}})
    emit({"phase": "conv_times", "what": f"the {CONV_LAYERS} 3x3 convs of one serving forward "
          f"at batch {CONV_BATCH}, bf16, ms summed", "kernel_ms": {v: tot[v]["ms"] for v in tot},
          **shared, "tflops": {v: shared["gflop"] / tot[v]["ms"] for v in tot},
          "cudnn_tflops": shared["gflop"] / shared["cudnn_ms"], "bound_ms_by": bound_by,
          "per_shape": per_shape})
    return {v: {**tot[v], "plain_ms": shared["plain_ms"], "bound_ms": shared["bound_ms"],
                "bound_by": max(bound_by, key=bound_by.get), "library_ms": shared["cudnn_ms"],
                "library_with_epilogue_ms": shared["cudnn_with_epilogue_ms"]} for v in tot}


def phase_conv_ablate():
    """conv_ablate: the ablation probe's variants at its shape. ``full`` and
    ``full-9mm`` are the two kernels (held to plain); the partial variants
    run products on zeroed shared memory and are timings only."""
    import torch

    from tracknetv3_tpu_torch.ops import conv3x3 as c3

    dev = torch.device(DEVICE)
    N, H, W, Ci, Co = ABLATE_SHAPE
    x, k, _ = _conv_data(N, H, W, Ci, Co, 70, dev)
    packed = c3.pack_weights(k, torch.bfloat16, device=dev)
    want = c3.conv3x3_bias_relu_plain(x, packed, None, relu=False)
    calls = {"full": lambda: c3.conv3x3_bias_relu(x, packed, None, variant="k3c", relu=False),
             "full-9mm": lambda: c3.conv3x3_bias_relu(x, packed, None, variant="9tap",
                                                      relu=False)}
    for name in c3.ABLATION_VARIANTS:
        calls[name] = lambda name=name: c3.conv3x3_ablation(x, packed, variant=name)
    flops = 2 * N * H * W * 9 * Ci * Co
    res = {"phase": "conv_ablate", "shape_NHWC": [N, H, W, Ci], "Co": Co,
           "gflop": flops / 1e9, "variants": {}}
    bad = []
    for name, call in calls.items():
        out = call()
        torch.cuda.synchronize()
        ms = time_launches(lambda i: call(), n=10, windows=3)
        res["variants"][name] = {"ms": ms, "share_of_bf16_peak": flops / (ms * 1e-3) / BF16_FLOPS}
        if name in ("full", "full-9mm"):
            cmp = _conv_compare(out, want, x)
            emit({"phase": "conv_ablate", "variant": name, "vs_plain": cmp}, detail=True)
            res["variants"][name]["ulps_apart"] = cmp["ulps_apart"]
            if not _conv_sound(cmp):
                bad.append(f"{name}: {cmp}")
    # the plain version, cuDNN alone and the bound at the same shape
    import torch.nn.functional as F

    w = k.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    torch.backends.cudnn.benchmark = True
    res["plain_ms"] = time_launches(
        lambda i: c3.conv3x3_bias_relu_plain(x, packed, None, relu=False), n=2, windows=3)
    res["cudnn_ms"] = time_launches(lambda i: F.conv2d(x, w, padding=1), n=10, windows=3)
    res["bound_ms"], res["bound_by"] = bound_ms(
        2 * (N * H * W * (Ci + Co) + 9 * Ci * Co), flops, BF16_FLOPS)
    emit(res)
    if bad:
        fail("conv_ablate", "; ".join(bad))


def synthetic_video(T: int, seed: int):
    """(T, H, W, 3) RGB uint8 frames drawn as ``write_synthetic_dataset``
    draws a rally (seeded textured background, a bright disk of radius 4
    on a parabolic arc, one 40-frame pass after another) and the disk's
    (x, y) per frame."""
    rng = np.random.default_rng(seed)
    bg = np.full((H, W, 3), (40, 90, 40), np.int32)
    bg = (bg + rng.integers(0, 40, (H, W, 3))).astype(np.uint8)
    frames = np.repeat(bg[None], T, axis=0)
    dy, dx = np.mgrid[-4:5, -4:5]
    disk = dy ** 2 + dx ** 2 <= 16
    centers = []
    for t in range(T):
        u = (t % 40) / 39
        x = int(W * 0.1 + W * 0.8 * u)
        y = int(H * 0.7 - H * 0.5 * math.sin(math.pi * u))
        frames[t, y - 4 : y + 5, x - 4 : x + 5][disk] = 255
        centers.append((x, y))
    return frames, np.asarray(centers)


def phase_serve(tmp: str):
    import torch

    from tracknetv3_tpu_torch.inference import TrackNetPredictor
    from tracknetv3_tpu_torch.models.factory import get_model
    from tracknetv3_tpu_torch.ops import conv3x3 as c3
    from tracknetv3_tpu_torch.ops import pool_up2x as pu
    from tracknetv3_tpu_torch.training.checkpoint import save_checkpoint
    from tracknetv3_tpu_torch.utils.io import write_pred_csv

    tn = os.path.join(tmp, "exp", "TrackNet_best.pt")  # written by phase_slice
    inp = os.path.join(tmp, "InpaintNet_seed17.pt")
    save_checkpoint(inp, epoch=0, max_val_acc=0.0,
                    model=get_model("InpaintNet", generator=torch.Generator().manual_seed(17)),
                    param_dict={"model_name": "InpaintNet", "seq_len": 16})
    frames, centers = synthetic_video(SERVE_T, seed=21)
    torch.backends.cudnn.benchmark = True  # as the predict CLI sets it
    tn_detect = detecting_checkpoint(tn, frames, os.path.join(tmp, "TrackNet_detect.pt"))
    launches_by = {}
    for backend, bs, T in SERVE_RUNS:
        video, track = frames[:T], centers[:T]
        p = TrackNetPredictor(tn, inp, batch_size=bs, device=DEVICE,
                              conv_backend=backend)  # weight, bf16
        csv_path = os.path.join(tmp, f"serve_{backend}_b{bs}_ball.csv")

        def once():
            t0 = time.perf_counter()
            staged = p.stage_frames(video)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pred = p.run_staged(staged)  # ends in the one fetch
            t2 = time.perf_counter()
            pred = p.inpaint_trajectory(pred, (W, H))
            write_pred_csv(pred, csv_path)
            t3 = time.perf_counter()
            return pred, t2 - t1, t3 - t0

        once()  # warm-up: cuDNN autotuning, allocator growth
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_s, e2e_s = [], []
        for i in range(3):
            if i == 0:  # counts of this run only
                pu.LAUNCHES.update(dict.fromkeys(pu.LAUNCHES, 0))
                c3.LAUNCHES.update(dict.fromkeys(c3.LAUNCHES, 0))
            pred, r, e = once()
            if i == 0:
                launches = {**pu.LAUNCHES, **c3.LAUNCHES}
            run_s.append(r)
            e2e_s.append(e)
        peak = torch.cuda.max_memory_allocated()
        chunks = -(-(T - L + 1) // bs)
        with open(csv_path) as f:
            n_rows = sum(1 for _ in f) - 1
        xs, ys, vis = (np.asarray(pred[k]) for k in ("X", "Y", "Visibility"))
        inside = bool(((xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)).all())
        hit = (vis == 1) & (np.abs(xs - track[:, 0]) <= 4) & (np.abs(ys - track[:, 1]) <= 4)
        res = {"phase": "serve", "conv_backend": backend, "batch_size": bs, "frames": T,
               "chunks": chunks, "launches": launches, "csv_rows": n_rows,
               "inside_frame": inside,
               "visible_frames": int(vis.sum()), "within_4px_of_disk": int(hit.sum()),
               "run_fps": T / statistics.median(run_s),
               "e2e_fps": T / statistics.median(e2e_s),
               "run_s": run_s, "e2e_s": e2e_s, "peak_mem_bytes": peak}
        emit(res)
        want = {"maxpool2x2": 3 * chunks, "up2x_nearest": 3 * chunks,
                "conv3x3_k3c": CONV_LAYERS * chunks * (backend == "hand_k3c"),
                "conv3x3_9tap": CONV_LAYERS * chunks * (backend == "hand_9tap")}
        if n_rows != T:
            fail("serve", f"{backend} batch {bs}: {n_rows} CSV rows != {T}")
        if launches != want:
            fail("serve", f"{backend} batch {bs}: launches {launches} != {want} "
                 f"({chunks} chunks)")
        if not inside:
            fail("serve", f"{backend} batch {bs}: a coordinate lies outside the {W}x{H} frame")
        launches_by[backend, bs] = launches
        del p
        serve_vs_cpu(tn_detect, inp, video, track, bs, backend)
        torch.cuda.empty_cache()
    return launches_by, frames


def _unfolded(tn: str, dtype):
    """The checkpoint's TrackNet in eval mode on the card (cuDNN, BatchNorm
    after each conv, torch pool and upsample): the plain serving forward."""
    import torch

    from tracknetv3_tpu_torch.training.checkpoint import load_model_from_checkpoint

    model, _ = load_model_from_checkpoint(tn, dtype=dtype)
    return model.to(DEVICE, memory_format=torch.channels_last).eval()


def _row(pred, t):
    return pred["X"][t], pred["Y"][t], pred["Visibility"][t]


def _inpaint_vs_cpu(p, cpu, traj):
    """InpaintNet on the card and on the CPU over one trajectory: (frames
    masked for inpainting, unmasked frames that differ, masked frames
    that differ by more than 1 px or in visibility)."""
    from tracknetv3_tpu_torch.ops.postprocess import generate_inpaint_mask

    got = p.inpaint_trajectory(traj, (W, H))
    want = cpu.inpaint_trajectory(traj, (W, H))
    mask = generate_inpaint_mask(traj, th_h=H * 0.05)  # inpaint_trajectory's th_h
    off_mask = far = 0
    for t, m in enumerate(mask):
        (gx, gy, gv), (wx, wy, wv) = _row(got, t), _row(want, t)
        if not m:
            off_mask += (gx, gy, gv) != (wx, wy, wv)
        else:
            far += abs(gx - wx) > 1 or abs(gy - wy) > 1 or gv != wv
    return sum(mask), off_mask, far


def detecting_checkpoint(tn: str, frames: np.ndarray, path: str) -> str:
    """The trained TrackNet with its predictor's bias lowered so that the
    top 1% of the logits of the video's first 16 windows pass 0.5: heatmaps
    as sparse as a trained model's, so that the rows ``serve_vs_cpu``
    compares hold detections whatever a 26-step training learnt."""
    import torch

    from tracknetv3_tpu_torch.inference import TrackNetPredictor
    from tracknetv3_tpu_torch.models.fused_forward import tracknet_fused_forward
    from tracknetv3_tpu_torch.ops.preprocess import make_staged_preprocessor
    from tracknetv3_tpu_torch.training.checkpoint import (
        load_model_from_checkpoint,
        save_checkpoint,
    )

    p = TrackNetPredictor(tn, batch_size=16, device=DEVICE)
    staged = p.stage_frames(frames)
    pre = make_staged_preprocessor(p.bg_mode, L, False, out_dtype=p.compute_dtype)
    with torch.inference_mode():
        x = pre(staged.buf, staged.median, torch.arange(16, device=DEVICE))
        logits = tracknet_fused_forward(p.params, x, apply_sigmoid=False).flatten()
        cut = float(torch.topk(logits, logits.numel() // 100).values[-1])
    model, pd = load_model_from_checkpoint(tn, dtype=torch.float32)
    with torch.no_grad():
        model.predictor.bias -= cut
    save_checkpoint(path, epoch=0, max_val_acc=0.0, model=model, param_dict=pd)
    return path


def serve_vs_cpu(tn: str, inp: str, frames: np.ndarray, centers: np.ndarray,
                 bs: int, backend: str) -> None:
    """One more served run on the card (bf16, the kernels) with each
    chunk's window probabilities copied to the host and held to the
    unfolded TrackNet on the same input; then a CPU predictor replays those
    probabilities through its ``run_staged`` and ``inpaint_trajectory``,
    which must give the card's rows."""
    import torch

    from tracknetv3_tpu_torch.inference import TrackNetPredictor

    T = len(frames)
    p = TrackNetPredictor(tn, inp, batch_size=bs, device=DEVICE, conv_backend=backend)
    t0 = time.time()
    model = _unfolded(tn, torch.bfloat16)
    forward = p._windows
    host_probs, gaps = [], []

    def recording(pre, buf, med, starts):
        probs = forward(pre, buf, med, starts)
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=True, benchmark=False, deterministic=cudnn.deterministic,
                         allow_tf32=False):  # one pass: autotuning costs more than it saves
            ref = torch.sigmoid(model(pre(buf, med, starts).permute(0, 3, 1, 2)))
        d = (probs - ref).abs()
        gaps.append((float(d.max()), float(d.mean())))
        host_probs.append(probs.cpu())
        return probs

    p._windows = recording
    card = p.run_staged(p.stage_frames(frames))
    del model
    card_s = time.time() - t0

    cpu = TrackNetPredictor(tn, inp, batch_size=bs, device="cpu")
    replay = iter(host_probs)
    cpu._windows = lambda pre, buf, med, starts: next(replay)
    want = cpu.run_staged(cpu.stage_frames(frames))
    differ = [t for t in range(T) if _row(card, t) != _row(want, t)]
    # InpaintNet over the served rows, and over the disk's drawn track with
    # an occlusion cut into every 40-frame pass (frames 12-15, as in the
    # training data), so that its own output reaches the rows
    occluded = {"Frame": list(range(T)), "X": [int(v) for v in centers[:, 0]],
                "Y": [int(v) for v in centers[:, 1]], "Visibility": [1] * T}
    for t in range(T):
        if 12 <= t % 40 < 16:
            occluded["X"][t] = occluded["Y"][t] = occluded["Visibility"][t] = 0
    inpaint = {name: dict(zip(("masked", "unmasked_differ", "masked_differ_over_1px"),
                              _inpaint_vs_cpu(p, cpu, traj)))
               for name, traj in (("served", card), ("occluded", occluded))}
    bound, mean_bound = SERVE_PARITY_BOUNDS["bfloat16"]
    worst = max(g[0] for g in gaps), max(g[1] for g in gaps)
    visible = sum(card["Visibility"])
    emit({"phase": "serve_vs_cpu", "conv_backend": backend, "batch_size": bs,
          "chunks": len(gaps),
          "bf16_max_abs_prob_err": worst[0], "bf16_mean_abs_prob_err_worst_chunk": worst[1],
          "bound": bound,
          "mean_bound": mean_bound, "rows": T, "visible_rows": visible,
          "rows_differ": len(differ),
          "first_differ": differ[:5], "inpaint": inpaint, "card_s": card_s,
          "cpu_s": time.time() - t0 - card_s})
    emit({"phase": "serve_vs_cpu", "conv_backend": backend, "batch_size": bs,
          "bf16_chunk_max_errs": [g[0] for g in gaps]}, detail=True)
    if not (worst[0] <= bound and worst[1] <= mean_bound):
        fail("serve_vs_cpu", f"{backend} batch {bs}: a chunk's forward is off the unfolded "
             f"model by max {worst[0]} / mean {worst[1]} (bounds {bound} / {mean_bound})")
    if not visible:
        fail("serve_vs_cpu", f"{backend} batch {bs}: no detection in the rows compared")
    if differ:
        fail("serve_vs_cpu", f"{backend} batch {bs}: {len(differ)} rows differ from the CPU's, "
             f"first {differ[:5]}")
    for name, r in inpaint.items():
        if r["unmasked_differ"] or r["masked_differ_over_1px"]:
            fail("serve_vs_cpu", f"{backend} batch {bs}: InpaintNet on {name} rows: {r}")
    if not inpaint["occluded"]["masked"]:
        fail("serve_vs_cpu", f"{backend} batch {bs}: no frame was masked for inpainting")


@contextlib.contextmanager
def wrong_forward(name: str):
    """The folded forward with one deliberate fault, for the upper readings
    of the bf16 parity bound: ``pool<n>_stride2`` takes the n-th pool as a
    stride-2 slice, ``up<n>_tiled`` tiles the n-th upsample instead of
    interleaving it, ``bias_after_cast`` adds each 3x3 conv's bias in
    bfloat16 (a rounding, not a fault: read, not held to the bound)."""
    import torch
    import torch.nn.functional as F

    from tracknetv3_tpu_torch.models import fused_forward as ff

    saved = {k: getattr(ff, k) for k in ("maxpool2x2", "up2x_nearest", "_conv_relu")}
    calls = {"pool": 0, "up": 0}
    kind = name.split("_")[0]  # pool<n>, up<n> or bias
    nth = int(kind[-1]) if kind[-1].isdigit() else 0

    def pool(x):
        calls["pool"] += 1
        if calls["pool"] == nth:
            return x[:, :, ::2, ::2].contiguous(memory_format=torch.channels_last)
        return saved["maxpool2x2"](x)

    def up(x):
        calls["up"] += 1
        if calls["up"] == nth:
            return x.repeat(1, 1, 2, 2).contiguous(memory_format=torch.channels_last)
        return saved["up2x_nearest"](x)

    def conv_relu(x, w, b, backend="cudnn"):
        return torch.add(F.conv2d(x, w, padding=1), b.to(x.dtype)).relu_()

    attr, fn = {"pool": ("maxpool2x2", pool), "up": ("up2x_nearest", up),
                "bias": ("_conv_relu", conv_relu)}[kind.rstrip("0123456789")]
    setattr(ff, attr, fn)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ff, k, v)


def _parity(out, ref, bound: float, mean_bound: float) -> dict:
    """|dp| of a forward against the reference probabilities, and whether it
    is within the (max, mean) bound."""
    d = (out - ref).abs()
    err, mean = float(d.max()), float(d.mean())
    return {"max": err, "mean": mean, "flips": int(((out > 0.5) != (ref > 0.5)).sum()),
            "within_bound": err <= bound and mean <= mean_bound}


def deterministic_checkpoint(tmp: str):
    """The serve cell's TrackNet trained as ``phase_slice`` trains it (the
    README configuration, 2 epochs of the synthetic dataset, seed 13), but
    through ``training.loop.train`` with cuDNN's autotuning off,
    deterministic algorithms and TF32 off. The train CLI turns autotuning
    on, and with it the checkpoint, and a wrong forward's reading on it,
    change from run to run; this one repeats, and so do serve_parity's
    margins. Returns its path and a SHA-256 of its parameters."""
    import hashlib

    import torch

    from tracknetv3_tpu_torch.config import TrainConfig
    from tracknetv3_tpu_torch.training.loop import train

    save_dir = os.path.join(tmp, "exp_deterministic")
    cfg = TrainConfig(seq_len=L, bg_mode="concat", alpha=0.5, batch_size=B, epochs=2,
                      save_dir=save_dir)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False), \
                contextlib.redirect_stdout(sys.stderr):
            model = train(cfg, data_dir=os.path.join(tmp, "data"), device=DEVICE)["model"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    digest = hashlib.sha256()
    for k, v in model.state_dict().items():
        digest.update(k.encode() + v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return os.path.join(save_dir, "TrackNet_best.pt"), digest.hexdigest()


def phase_serve_parity(tmp: str, frames: np.ndarray) -> None:
    import torch

    from tracknetv3_tpu_torch.device import tf32_off
    from tracknetv3_tpu_torch.inference import TrackNetPredictor
    from tracknetv3_tpu_torch.models.fused_forward import tracknet_fused_forward
    from tracknetv3_tpu_torch.ops.preprocess import make_staged_preprocessor

    dev = torch.device(DEVICE)
    t0 = time.time()
    tn, digest = deterministic_checkpoint(tmp)
    emit({"phase": "serve_parity", "checkpoint": "trained with deterministic cuDNN, no "
          "autotuning, TF32 off", "params_sha256": digest, "train_s": time.time() - t0})
    torch.backends.cudnn.benchmark = False  # one chunk each: autotuning costs more than it saves
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        # the cudnn route, with the faults patched into it; the hand routes beside
        p = TrackNetPredictor(tn, batch_size=16, compute_dtype=dtype, device=dev,
                              conv_backend="cudnn")
        staged = p.stage_frames(frames)
        pre = make_staged_preprocessor(p.bg_mode, L, False, out_dtype=dtype)
        model = _unfolded(tn, dtype)
        bound, mean_bound = SERVE_PARITY_BOUNDS[name]
        variants = ("folded",)
        hand = {}  # the folded weights packed for each hand conv backend
        if name == "bfloat16":
            variants += WRONG_FORWARDS + ("bias_after_cast",)
            hand = {b: TrackNetPredictor(tn, batch_size=16, compute_dtype=dtype, device=dev,
                                         conv_backend=b).params for b in HAND_BACKENDS}
        worst = {}  # variant -> (max, mean) |dp| over the chunks; the wrong ones: the least
        for s in PARITY_STARTS:
            res = {}
            with torch.inference_mode(), tf32_off():
                x = pre(staged.buf, staged.median, s + torch.arange(16, device=dev))
                ref = torch.sigmoid(model(x.permute(0, 3, 1, 2)))
                for v in variants:
                    with contextlib.nullcontext() if v == "folded" else wrong_forward(v):
                        out = tracknet_fused_forward(p.params, x).permute(0, 3, 1, 2)
                    res[v] = _parity(out, ref, bound, mean_bound)
                    if v == "folded":
                        cudnn_out = out
                for b, params in hand.items():
                    out = tracknet_fused_forward(params, x).permute(0, 3, 1, 2)
                    res[b] = _parity(out, ref, bound, mean_bound)
                    res[b]["max_vs_cudnn_route"] = float((out - cudnn_out).abs().max())
            emit({"phase": "serve_parity", "windows": [s, s + 16], "dtype": name,
                  "tf32": False, "max_abs_prob_err": res["folded"]["max"],
                  "mean_abs_prob_err": res["folded"]["mean"],
                  "threshold_flips": res["folded"]["flips"], "pixels": out.numel(),
                  "bound": bound, "mean_bound": mean_bound,
                  "hand_backends": {b: res[b] for b in hand},
                  "wrong_forwards": {v: r for v, r in res.items()
                                     if v != "folded" and v not in hand}}, detail=True)
            for v, r in res.items():
                pick = min if v in WRONG_FORWARDS else max
                old = worst.get(v, (r["max"], r["mean"]))
                worst[v] = (pick(old[0], r["max"]), pick(old[1], r["mean"]))
            for v in ("folded",) + tuple(hand):
                if not res[v]["within_bound"]:
                    fail("serve_parity", f"{name} windows {s}-{s + 16}, {v}: max |dp| "
                         f"{res[v]['max']} (bound {bound}), mean {res[v]['mean']} "
                         f"(bound {mean_bound})")
            caught = [v for v in WRONG_FORWARDS if v in res and res[v]["within_bound"]]
            if caught:
                fail("serve_parity", f"{name} windows {s}-{s + 16}: the bound passes the "
                     f"wrong forwards {caught}")
        emit({"phase": "serve_parity", "dtype": name, "tf32": False,
              "chunks_of_16_windows": len(PARITY_STARTS), "bound": bound, "mean_bound": mean_bound,
              "max_and_mean_abs_prob_err": {
                  v: {"max": m[0], "mean": m[1],
                      "over_chunks": "least" if v in WRONG_FORWARDS else "worst",
                      **({"must_fail": True} if v in WRONG_FORWARDS else {})}
                  for v, m in worst.items()}})
        del p, staged, x, out, model, ref, hand


def _baseline_modules(root: str):
    """The copy and loss kernel modules of the port in another checkout,
    imported under another package name so that both trees live in one
    process; each builds its kernels from its own sources into its own
    ``build/``."""
    import importlib
    import importlib.util

    name = "baseline_tracknetv3_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "tracknetv3_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.ops.shift_copy"),
            importlib.import_module(f"{name}.ops.wbce_disk"))


def main() -> int:
    global VERBOSE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conv_only", action="store_true",
                    help="build, conv_vs_plain and conv_ablate alone; no kernels line")
    ap.add_argument("--copy_only", action="store_true",
                    help="build and copy_vs_plain alone; no kernels line")
    ap.add_argument("--loss_only", action="store_true",
                    help="build, kernel_vs_plain and kernel_times alone; no kernels line")
    ap.add_argument("--baseline", metavar="DIR",
                    help="with --copy_only or --loss_only: a checkout of another commit "
                         "(e.g. the parent's, unpacked with git archive); its copy and loss "
                         "kernels are built from its sources, checked bit for bit against "
                         "this tree's and timed in turns with them (old, new, new, old)")
    ap.add_argument("--verbose", action="store_true",
                    help="print the per-shape detail lines too")
    args = ap.parse_args()
    VERBOSE = args.verbose
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

    only = ("conv" if args.conv_only else "copy" if args.copy_only
            else "loss" if args.loss_only else None)
    if args.baseline and only not in ("copy", "loss"):
        print("chip_smoke: --baseline goes with --copy_only or --loss_only", file=sys.stderr)
        return 2
    baseline = _baseline_modules(args.baseline) if args.baseline else None
    card = phase_env()
    phase_build(baseline)
    if only:
        if only == "conv":
            phase_conv()
            phase_conv_ablate()
        elif only == "copy":
            phase_copy(baseline)
        else:
            phase_kernels(baseline)
        print(card, flush=True)
        emit({"ok": True, "only": only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    err, ms, plain_ms, bound = phase_kernels()
    bn_times = phase_bn()
    copies = phase_copy()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, bn_launches, step_ms, peak, model = phase_slice(tmp)
        phase_step_parity(os.path.join(tmp, "data"))
        copy_launches = phase_seg_train(tmp, model)
        del model
        phase_seg_parity(os.path.join(tmp, "data"))
        torch.cuda.empty_cache()
        pool_up = phase_pool_up()
        conv = phase_conv()
        phase_conv_ablate()
        serve_launches, frames = phase_serve(tmp)
        phase_serve_parity(tmp, frames)

    src = "tracknetv3_tpu_torch/csrc/wbce_disk.cu"
    replaces = {"fwd": "tracknetv3_tpu/ops/pallas_wbce.py:73",
                "bwd": "tracknetv3_tpu/ops/pallas_wbce.py:87"}
    # K1/K2 bounds: the larger of the bytes and the SASS instructions at the
    # issue rate (kernel_times)
    lines = [
        {"name": f"wbce_disk_{k}", "route": "cuda", "source": src,
         "replaces": replaces[k], "launches": launches[k], "max_abs_err": err[k],
         "ms": ms[k], "plain_ms": plain_ms[k], "bound_ms": bound[k][0],
         "bound_by": bound[k][1], "library_ms": None}
        for k in ("fwd", "bwd")
    ]
    # P6/P7: times and bounds summed over the three calls of one forward at
    # batch 16; the plain version is one PyTorch call, so it is the library's
    replaces = {"maxpool2x2": "tools/probe_bn_pool.py:203",
                "up2x_nearest": "tools/probe_bn_pool.py:236"}
    lines += [
        {"name": k, "route": "cuda", "source": "tracknetv3_tpu_torch/csrc/pool_up2x.cu",
         "replaces": replaces[k], "launches": serve_launches["cudnn", 16][k],
         "max_abs_err": v["max_abs_err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
         "bound_ms": v["bound_ms"], "bound_by": "/".join(sorted(set(v["bound_by"]))),
         "library_ms": v["plain_ms"]}
        for k, v in pool_up.items()
    ]
    # BatchNorm: times and bounds summed over the 17 calls of one train step
    # at batch 10 (bf16); launches per run of the train path. The backward
    # kernels replace JAX's autodiff of the epilogue (no Pallas source).
    replaces = {"bn_stats": "tools/probe_bn_pool.py:128",
                "bn_relu_fwd": "tools/probe_bn_pool.py:167",
                "bn_relu_bwd_reduce": "tracknetv3_tpu/models/fused_forward.py:285",
                "bn_relu_bwd_apply": "tracknetv3_tpu/models/fused_forward.py:311"}
    lines += [
        {"name": k, "route": "cuda", "source": "tracknetv3_tpu_torch/csrc/batchnorm.cu",
         "replaces": replaces[k], "launches": bn_launches[k], **v}
        for k, v in bn_times.items()
    ]
    # P1-P3: times and bounds summed over the 17 convs of one forward at batch
    # 16 (bf16); library: cuDNN's conv alone, and with the torch epilogue
    # passes that today's default route adds. Launches: the hand_k3c serve of
    # the whole video, the hand_9tap serve of its 64-frame cut.
    replaces = {"k3c": "tools/probe_pallas_conv.py:48", "9tap": "tools/probe_pallas_conv.py:130"}
    also = {"k3c": ["tools/probe_pallas_conv.py:130 (sheet=True)",
                    "tools/probe_pallas_ablate.py:63 (full and the partial variants)"],
            "9tap": ["tools/probe_pallas_ablate.py:63 (full-9mm)"]}
    served = {"k3c": ("hand_k3c", 16), "9tap": ("hand_9tap", 16)}
    lines += [
        {"name": f"conv3x3_{k}", "route": "cuda",
         "source": "tracknetv3_tpu_torch/csrc/conv3x3.cu", "replaces": replaces[k],
         "also_replaces": also[k],
         "launches": serve_launches[served[k]][f"conv3x3_{k}"], **v}
        for k, v in conv.items()
    ]
    # P8/P9: each kernel at the train path's shape of copy_vs_plain (the roll,
    # which no path of the system runs, at its probe's); launches summed over
    # seg_train's four runs of the train CLI
    replaces = {"window_copy": "tools/probe_mosaic_caps.py:88",
                "repeat_rows": "tools/probe_mosaic_caps.py:164",
                "roll_cols": "tools/probe_mosaic_caps.py:201"}
    also = {"window_copy": ["tools/probe_mosaic_caps.py:107 (U2)",
                            "tools/probe_mosaic_caps.py:126 (U3: staged)",
                            "tools/probe_mosaic_caps.py:147 (U4)",
                            "tools/probe_mosaic_caps.py:230 (U7)"],
            "repeat_rows": [], "roll_cols": []}
    lines += [
        {"name": k, "route": "cuda", "source": "tracknetv3_tpu_torch/csrc/shift_copy.cu",
         "replaces": replaces[k], "also_replaces": also[k], "launches": copy_launches[k],
         "on_a_ported_path": k != "roll_cols", **copies[k]}
        for k in COPY_KERNELS
    ]
    emit({"kernels": lines})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
