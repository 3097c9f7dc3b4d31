"""TrackNet train and eval steps.

Port of the JAX package's ``training/steps.py`` (TrackNet, plain batches):
batch assembly (channel stacking, /255), sample mixup, forward, loss,
backward and the optimizer update. PyTorch runs eagerly, so a step is a
function that updates the model and optimizer in place and returns the
loss as a device scalar (no host sync).

Mixup randomness is explicit: ``sample_mixup_params`` draws the per-sample
``lam ~ Beta(alpha, alpha)`` (then ``max(lam, 1 - lam)``) and the
permutation from a ``numpy.random.Generator`` on the host, once per step,
and the B values travel with the batch. Tests hand the same ``perm``/``lam``
to both packages.

On the card the loss is the hand-written kernel pair ``wbce_disk_loss``
with ``pack_mixup_targets`` (``pack_plain_targets`` when ``alpha <= 0``):
the (B, H, W, L) label tensor never exists. On the CPU the same call runs
the plain composition.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.heatmap import make_heatmaps
from ..ops.losses import wbce
from ..ops.preprocess import window_channels
from ..ops.wbce_disk import pack_mixup_targets, pack_plain_targets, wbce_disk_loss

Batch = Dict[str, torch.Tensor]


def assemble_tracknet_inputs(batch: Batch, bg_mode: str) -> torch.Tensor:
    """Model input x (B, H, W, C) float32 in [0, 1] from a device batch."""
    rgb, diff, median = (
        batch[k].float() if k in batch else None for k in ("rgb", "diff", "median")
    )
    return window_channels(rgb, diff, median, bg_mode)


def assemble_tracknet_labels(batch: Batch, h: int, w: int) -> torch.Tensor:
    """Materialised label heatmaps y (B, h, w, L) (eval path)."""
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

    ``batch`` holds device tensors (``rgb``/``diff``/``median``, ``cxcy``);
    with ``alpha > 0`` the caller passes the step's ``perm``/``lam`` device
    tensors from ``sample_mixup_params``. ``step_idx`` is the optimizer
    step (from 0) that ``schedule`` reads.
    """

    def step(batch: Batch, step_idx: int, perm=None, lam=None) -> torch.Tensor:
        model.train()
        x = assemble_tracknet_inputs(batch, bg_mode)
        if alpha > 0:
            x = sample_mixup_inputs(x, perm, lam)
            targets = pack_mixup_targets(batch["cxcy"], perm, lam)
        else:
            targets = pack_plain_targets(batch["cxcy"])
        if schedule is not None:
            for group in optimizer.param_groups:
                group["lr"] = schedule(step_idx)
        optimizer.zero_grad(set_to_none=True)
        logits = model(_to_model_input(x))  # (B, L, H, W)
        loss = wbce_disk_loss(logits.movedim(1, -1), *targets)
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
