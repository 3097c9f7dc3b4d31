"""The first TrackNet train steps, plainly (the published ``train.py`` with
the README command: sample mixup, WBCE, Adam).

A step: the input channels ``[median, frame 0, ..., frame L-1]`` (RGB, /
255) of each window; sample mixup ``x = lam x + (1 - lam) x[perm]`` with
the step's ``lam`` and ``perm``; TrackNet in train mode (BatchNorm over the
batch's statistics) in float32, TF32 off; labels: a disk of radius 2.5
around each frame's centre (none where the centre is (0, 0)), mixed as the
inputs; the loss ``-mean((1 - p)^2 y log p + p^2 (1 - y) log(1 - p))``
with each log floored at ``log(1e-7)``; Adam (0.9, 0.999, 1e-8).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .tracknet import Quant, plain_math, tracknet_logits

SIGMA = 2.5
LOG_FLOOR = math.log(1e-7)


def inputs(frames: np.ndarray, median: np.ndarray, device) -> torch.Tensor:
    """(B, L, h, w, 3) and (B, h, w, 3) uint8 -> (B, 3 (L + 1), h, w)."""
    B, L, h, w, _ = frames.shape
    f = torch.from_numpy(frames).to(device).to(torch.float32) / 255.0
    m = torch.from_numpy(median).to(device).to(torch.float32) / 255.0
    f = f.permute(0, 1, 4, 2, 3).reshape(B, 3 * L, h, w)
    return torch.cat([m.permute(0, 3, 1, 2), f], 1)


def disks(centers: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """(B, L, 2) integer centres -> (B, L, h, w) float32 disk labels."""
    c = torch.from_numpy(centers.astype(np.float32)).to(device)
    rows = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    cols = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    d2 = (rows - c[..., 1, None, None]) ** 2 + (cols - c[..., 0, None, None]) ** 2
    seen = ((c[..., 0] != 0) | (c[..., 1] != 0)).to(torch.float32)[..., None, None]
    return (d2 <= SIGMA ** 2).to(torch.float32) * seen


def loss_of(params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor], batch: Dict,
            quant: Quant = None, rows: slice = slice(None)) -> torch.Tensor:
    """The step's loss; ``rows`` keeps only some rows of the mixed batch
    (the mean is over those)."""
    dev = next(iter(params.values())).device
    x = inputs(batch["frames"], batch["median"], dev)
    y = disks(batch["centers"], x.shape[2], x.shape[3], dev)
    perm = torch.from_numpy(batch["perm"]).to(dev)
    lam = torch.from_numpy(batch["lam"]).to(dev)[:, None, None, None]
    x = x * lam + x[perm] * (1.0 - lam)
    y = y * lam + y[perm] * (1.0 - lam)
    z = tracknet_logits({**params, **buffers}, x[rows], train=True, quant=quant)
    y = y[rows]
    p = torch.sigmoid(z)
    log_p = F.logsigmoid(z).clamp_min(LOG_FLOOR)
    log_1mp = F.logsigmoid(-z).clamp_min(LOG_FLOOR)
    return -((1.0 - p).square() * y * log_p + p.square() * (1.0 - y) * log_1mp).mean()


def run_steps(sd: Dict[str, torch.Tensor], param_names: List[str], batches: List[Dict],
              lr: float, quant: Quant = None, half_batch: bool = False) -> Dict:
    """Adam steps from ``sd`` over ``batches``: each step's loss, the first
    gradient per leaf and its norm, and each leaf's change after the last
    step.
    ``half_batch`` takes each loss over the first half of the batch."""
    with plain_math():
        params = {k: sd[k].detach().clone().requires_grad_(True) for k in param_names}
        buffers = {k: v for k, v in sd.items() if k not in params}
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        losses, grad_norms, grads1 = [], {}, {}
        for t, batch in enumerate(batches, start=1):
            rows = slice(0, len(batch["lam"]) // 2) if half_batch else slice(None)
            loss = loss_of(params, buffers, batch, quant, rows)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    if t == 1:
                        grad_norms[k] = float(g.norm())
                        grads1[k] = g.detach().clone()
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                    p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        change = {k: float((params[k].detach() - sd[k]).norm()) for k in param_names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change, "grads": grads1}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """Per leaf: |prog - ref| against the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a check can compare. ``loss_gap``: the first step's
    relative loss gap (``loss_gap_steps``: every step's). ``grad_gap``: the
    median leaf's gap of first-gradient norms, each leaf against the
    reference's norm of that leaf or of the median leaf, whichever is larger
    (``grad_gap_worst``: the worst leaf's). ``grad_diff``: the median leaf's
    norm of the first gradients' difference, against the same norm;
    ``head_grad_diff``: the largest of it over the leaves of the layers
    next to the loss, the last 3x3 conv with its BatchNorm and the 1x1
    predictor, whose gradient passes no ReLU or max-pool switch but one.
    ``change_gap``: the worst leaf's gap of the change of each leaf after
    the steps, each against the reference's change of that leaf or of the
    median leaf, whichever is larger, leaves whose reference gradient is
    under a thousandth of the median leaf's left out
    (``change_gap_median``: the median leaf's)."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    g_ref = ref["grad_norms"]
    g_med = float(np.median(list(g_ref.values())))
    grad = _leaf_gaps(prog["grad_norms"], g_ref, list(g_ref))
    diff = {k: float((prog["grads"][k].to(ref["grads"][k].device) - ref["grads"][k]).norm())
            / max(g_ref[k], g_med) for k in g_ref}
    last_conv = [k for k in g_ref if k.endswith(".conv.weight")][-1]
    head = [k for k in g_ref
            if k.startswith(last_conv[:-len("conv.weight")]) or k.startswith("predictor.")]
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    change = _leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    worst_g = max(grad, key=grad.get)
    worst_c = max(change, key=change.get)
    return {"loss_gap": steps[0], "grad_gap": float(np.median(list(grad.values()))),
            "grad_diff": float(np.median(list(diff.values()))),
            "head_grad_diff": max(diff[k] for k in head),
            "change_gap": change[worst_c], "change_worst_leaf": worst_c,
            "change_gap_median": float(np.median(list(change.values()))),
            "loss_gap_steps": steps, "grad_gap_worst": grad[worst_g], "grad_worst_leaf": worst_g,
            "grad_diff_worst": max(diff.values()),
            "grad_diff_leaves": {k: round(v, 6) for k, v in diff.items()},
            "grad_gap_leaves": {k: round(v, 6) for k, v in grad.items()},
            "leaves_left_out": float(len(g_ref) - len(moved))}
