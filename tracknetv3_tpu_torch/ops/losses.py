"""Losses (plain torch), as the JAX package's ``ops/losses.py``.

- ``wbce``: the focal-style weighted BCE on probabilities,
  ``-((1-p)^2 y log(clamp(p)) + p^2 (1-y) log(clamp(1-p)))`` with the
  clamp to [1e-7, 1], mean (or per-sample mean) reduction.
- ``wbce_from_logits``: the same loss from logits through ``logsigmoid``
  (never ``log(sigmoid)``), each log floored at ``log(1e-7)``.
- ``masked_mse``: InpaintNet's loss, the mean of ``(pred*mask -
  target*mask)^2``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-7
LOG_FLOOR = math.log(EPS)


def _reduce(loss: torch.Tensor, reduce: bool) -> torch.Tensor:
    if reduce:
        return loss.mean()
    return loss.reshape(loss.shape[0], -1).mean(dim=1)


def wbce(y_pred: torch.Tensor, y: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    p = y_pred.float()
    y = y.float()
    loss = -(
        (1.0 - p).square() * y * torch.log(p.clamp(EPS, 1.0))
        + p.square() * (1.0 - y) * torch.log((1.0 - p).clamp(EPS, 1.0))
    )
    return _reduce(loss, reduce)


def wbce_from_logits(
    logits: torch.Tensor, y: torch.Tensor, reduce: bool = True
) -> torch.Tensor:
    """Upcast only: bfloat16 logits compute in float32, float64 stay float64."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    z = logits.to(acc)
    y = y.to(acc)
    p = torch.sigmoid(z)
    log_p = F.logsigmoid(z).clamp_min(LOG_FLOOR)
    log_1mp = F.logsigmoid(-z).clamp_min(LOG_FLOOR)
    loss = -((1.0 - p).square() * y * log_p + p.square() * (1.0 - y) * log_1mp)
    return _reduce(loss, reduce)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``(pred * mask - target * mask)^2`` over every element, in
    float32 (float64 stays float64)."""
    acc = torch.promote_types(pred.dtype, torch.float32)
    pred, target, mask = pred.to(acc), target.to(acc), mask.to(acc)
    return (pred * mask - target * mask).square().mean()
