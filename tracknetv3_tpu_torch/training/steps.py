"""TrackNet train and eval steps.

Port of the JAX package's ``training/steps.py`` (TrackNet): batch assembly
(window expansion of segmented batches, the gather of device-resident
frames, frame-mixup blending, channel stacking, /255), sample mixup,
forward, loss, backward and the optimizer update. PyTorch runs eagerly, so
a step is a function that updates the model and optimizer in place and
returns the loss as a device scalar (no host sync).

The gathers of the assembly are the copy kernels of ``ops/shift_copy.py``
(``window_copy``, ``repeat_rows``) on a CUDA batch and their plain versions
on a CPU batch. They run on the uint8 frames and the cast to float32
follows (the JAX step casts first; the values are the same).

Mixup randomness is explicit: ``sample_mixup_params`` draws the per-sample
``lam ~ Beta(alpha, alpha)`` (then ``max(lam, 1 - lam)``) and the
permutation from a ``numpy.random.Generator`` on the host, once per step,
and the B values travel with the batch. Tests hand the same ``perm``/``lam``
to both packages.

On the card the loss is the hand-written kernel pair ``wbce_disk_loss``
with ``pack_mixup_targets`` (``pack_plain_targets`` when ``alpha <= 0``,
``pack_frame_mixup_targets`` on a frame-mixup batch): the (B, H, W, L) label
tensor never exists. On the CPU the same call runs the plain composition.
Frame mixup together with sample mixup needs four disks per label, which
the kernels' two-disk form does not hold: that step materialises the
labels and takes ``wbce_from_logits``, as the JAX step does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.heatmap import make_heatmaps
from ..ops.losses import wbce, wbce_from_logits
from ..ops.preprocess import window_channels
from ..ops.shift_copy import repeat_rows, window_copy
from ..ops.wbce_disk import (
    pack_frame_mixup_targets,
    pack_mixup_targets,
    pack_plain_targets,
    wbce_disk_loss,
)

Batch = Dict[str, torch.Tensor]


def _take_rows(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``buf[idx]`` for an index tensor of any shape: idx.shape + buf.shape[1:]."""
    out = window_copy(buf, idx.reshape(-1).contiguous(), 1)
    return out.reshape(tuple(idx.shape) + tuple(buf.shape[1:]))


def _expand_segments(segs: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(n_seg, seg + L - 1, h, w, c) unique frames -> the (n_seg * seg, L, h,
    w, c) overlapping windows, segment-major. The table of window starts is
    built from this batch's own shape (the tail batch has fewer segments)."""
    n_seg, span = segs.shape[:2]
    seg = span - seq_len + 1
    dev = segs.device
    starts = (torch.arange(n_seg, device=dev)[:, None] * span
              + torch.arange(seg, device=dev)[None, :]).reshape(-1)
    return window_copy(segs.reshape((n_seg * span,) + tuple(segs.shape[2:])), starts, seq_len)


def _blend_slots(frames: torch.Tensor, pair: torch.Tensor, pix_w: torch.Tensor) -> torch.Tensor:
    """Frame-mixup pixel blending: frames (B, L, h, w, c), pair (B, L, 2)
    indices (ja, jb) into a window's frames; out[b, l] = w * frames[b, ja]
    + (1 - w) * frames[b, jb] in float32."""
    B, L = frames.shape[:2]
    flat = frames.reshape((B * L,) + tuple(frames.shape[2:]))
    rows = torch.arange(B, device=frames.device)[:, None] * L + pair.long().movedim(-1, 0)
    fa = _take_rows(flat, rows[0]).to(torch.float32)
    fb = _take_rows(flat, rows[1]).to(torch.float32)
    w = pix_w.to(torch.float32)[..., None, None, None]
    return fa * w + fb * (1.0 - w)


def assemble_tracknet_inputs(batch: Batch, bg_mode: str) -> torch.Tensor:
    """Model input x (B, H, W, C) float32 in [0, 1] from a device batch:
    a plain one (``rgb`` / ``diff`` / ``median``), a segmented one
    (``seg_rgb`` / ``seg_diff``), one of device-resident frames (``res_idx``)
    or a frame-mixup one (``mix_pair``)."""
    rgb, diff, median = (batch.get(k) for k in ("rgb", "diff", "median"))

    if "res_idx" in batch:
        # the batch carries (B, L) flat frame indices into the split's buffers
        idx = batch["res_idx"]
        if "res_rgb_buf" in batch:
            rgb = _take_rows(batch["res_rgb_buf"], idx)
        if "res_diff_buf" in batch:
            diff = _take_rows(batch["res_diff_buf"], idx)
        if "res_median_buf" in batch:
            median = _take_rows(batch["res_median_buf"], batch["res_median_idx"])

    if "seg_rgb" in batch or "seg_diff" in batch:
        L = batch["cxcy"].shape[1]
        segs = batch["seg_rgb"] if "seg_rgb" in batch else batch["seg_diff"]
        if "seg_rgb" in batch:
            rgb = _expand_segments(batch["seg_rgb"], L)
        if "seg_diff" in batch:
            diff = _expand_segments(batch["seg_diff"], L)
        if median is not None:
            median = repeat_rows(median, segs.shape[1] - L + 1)

    if "mix_pair" in batch:
        # the blend gathers its two operands from the uint8 frames and casts them
        pair, pix_w = batch["mix_pair"], batch["mix_pix_w"]
        if rgb is not None:
            rgb = _blend_slots(rgb, pair, pix_w)
        if diff is not None:
            diff = _blend_slots(diff, pair, pix_w)

    rgb, diff, median = (None if t is None else t.float() for t in (rgb, diff, median))
    return window_channels(rgb, diff, median, bg_mode)


def assemble_tracknet_labels(batch: Batch, h: int, w: int) -> torch.Tensor:
    """Materialised label heatmaps y (B, h, w, L): the eval path, and the
    train step with both mixups."""
    if "mix_pair" in batch:
        centers = batch["mix_centers"]  # (B, L, 2, 2)
        hm_w = batch["mix_hm_w"].to(torch.float32)[..., None, None]
        map_a = make_heatmaps(centers[..., 0, 0], centers[..., 0, 1], h, w)
        map_b = make_heatmaps(centers[..., 1, 0], centers[..., 1, 1], h, w)
        maps = map_a * hm_w + map_b * (1.0 - hm_w)
    else:
        cxcy = batch["cxcy"]
        maps = make_heatmaps(cxcy[..., 0], cxcy[..., 1], h, w)  # (B, L, h, w)
    return maps.movedim(1, -1)


def sample_mixup_params(
    rng: np.random.Generator, batch_size: int, alpha: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample ``lam = max(l, 1 - l)``, ``l ~ Beta(alpha, alpha)`` (float32)
    and a permutation of the batch (int64), drawn on the host."""
    lam = rng.beta(alpha, alpha, size=batch_size)
    lam = np.maximum(lam, 1.0 - lam).astype(np.float32)
    return rng.permutation(batch_size).astype(np.int64), lam


def sample_mixup_inputs(x: torch.Tensor, perm: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """``x * lam + x[perm] * (1 - lam)`` per sample."""
    lx = lam.to(x.dtype).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return x * lx + x[perm] * (1.0 - lx)


def _to_model_input(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W); a contiguous x makes this a
    channels_last tensor, the layout cuDNN prefers."""
    return x.permute(0, 3, 1, 2)


def make_tracknet_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    bg_mode: str,
    alpha: float,
    schedule: Optional[Callable[[int], float]] = None,
):
    """Returns ``step(batch, step_idx, perm=None, lam=None) -> loss``.

    ``batch`` holds device tensors (the keys ``assemble_tracknet_inputs``
    reads, and ``cxcy``); with ``alpha > 0`` the caller passes the step's
    ``perm``/``lam`` device tensors from ``sample_mixup_params``.
    ``step_idx`` is the optimizer step (from 0) that ``schedule`` reads.
    """

    def step(batch: Batch, step_idx: int, perm=None, lam=None) -> torch.Tensor:
        model.train()
        frame_mix = "mix_pair" in batch
        x = assemble_tracknet_inputs(batch, bg_mode)
        if alpha > 0:
            x = sample_mixup_inputs(x, perm, lam)
        targets = y = None
        if frame_mix and alpha > 0:
            y = assemble_tracknet_labels(batch, x.shape[1], x.shape[2])
            ly = lam.to(y.dtype).reshape((y.shape[0],) + (1,) * (y.dim() - 1))
            y = y * ly + y[perm] * (1.0 - ly)
        elif frame_mix:
            targets = pack_frame_mixup_targets(batch["mix_centers"], batch["mix_hm_w"])
        elif alpha > 0:
            targets = pack_mixup_targets(batch["cxcy"], perm, lam)
        else:
            targets = pack_plain_targets(batch["cxcy"])
        if schedule is not None:
            for group in optimizer.param_groups:
                group["lr"] = schedule(step_idx)
        optimizer.zero_grad(set_to_none=True)
        logits = model(_to_model_input(x)).movedim(1, -1)  # (B, H, W, L)
        loss = wbce_from_logits(logits, y) if y is not None else wbce_disk_loss(logits, *targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_tracknet_eval_step(model: torch.nn.Module, bg_mode: str):
    """Returns ``step(batch) -> (loss, probs (B, H, W, L))``: running-stat
    BatchNorm, WBCE on probabilities against materialised labels."""

    @torch.no_grad()
    def step(batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        x = assemble_tracknet_inputs(batch, bg_mode)
        y = assemble_tracknet_labels(batch, x.shape[1], x.shape[2])
        probs = torch.sigmoid(model(_to_model_input(x))).movedim(1, -1)
        return wbce(probs, y), probs

    return step
