"""Validation loops of both models, single process.

The port of the JAX package's ``evaluation/loops.py``:

- ``eval_tracknet``: WBCE loss + 5-way confusion; the eval step's heatmaps
  are decoded on the device for the whole batch (``exact_decode``: the
  largest-bbox-area rule on the device, or ``"host"``: on the host), and
  ground-truth centers come from the analytic disk center
  (``metrics.gt_center_from_label``);
- ``eval_inpaintnet``: masked-MSE loss + the three confusions of
  ``INPAINTNET_EVAL_TYPES`` ('inpaint': refined vs ground truth,
  'reconstruct': refined vs the TrackNet prediction, 'baseline': the
  prediction vs ground truth), classified in model-input pixels.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np

from ..config import HEIGHT, INPAINTNET_EVAL_TYPES, WIDTH
from ..ops.detect import decode_heatmaps, decode_heatmaps_exact, decode_heatmaps_host
from .metrics import classify_detections, confusion_from_types, gt_center_from_label, metrics_dict


def _dedup_mask(ids: np.ndarray) -> np.ndarray:
    """True where a frame counts: after the first consecutive repeat of a
    (rally, frame) id within a sample (padding), the rest is dropped."""
    same = np.all(ids[:, 1:] == ids[:, :-1], axis=-1)
    keep = np.concatenate([np.ones((ids.shape[0], 1), bool), ~same], axis=1)
    return np.logical_and.accumulate(keep, axis=1)


def eval_tracknet(eval_step: Callable, loader: Iterable, tolerance: float = 4.0,
                  exact_decode: Union[bool, str] = False) -> Tuple[float, Dict]:
    """``eval_step(batch) -> (loss, probs (B, H, W, L))``; ``loader`` yields
    batches whose ``cxcy`` and ``id`` are host numpy arrays (or tensors).
    ``exact_decode``: False, the serving decoder (peak blob); True (or
    ``"device"``), the largest-bbox-area rule on the device; ``"host"``, the
    same rule on the host. Returns (mean batch loss, metrics dict)."""
    losses = []
    confusion = np.zeros(5)
    for batch in loader:
        loss, probs = eval_step(batch)
        losses.append(float(loss))
        wins = probs.movedim(-1, 1)  # (B, L, H, W)
        if exact_decode == "host":
            dec = decode_heatmaps_host(wins.float().cpu().numpy())
        elif exact_decode:
            dec = decode_heatmaps_exact(wins)
        else:
            dec = decode_heatmaps(wins)
        cx_p = np.asarray(_host(dec["cx"]))
        cy_p = np.asarray(_host(dec["cy"]))
        cxcy = np.asarray(_host(batch["cxcy"]))
        cx_t, cy_t = gt_center_from_label(cxcy[..., 0], cxcy[..., 1], 1.0, 1.0)
        types = classify_detections(cx_p, cy_p, cx_t, cy_t, tolerance)
        keep = _dedup_mask(np.asarray(_host(batch["id"])))
        confusion += confusion_from_types(types[keep])
    return float(np.mean(losses)) if losses else 0.0, metrics_dict(confusion)


def eval_inpaintnet(eval_step: Callable, loader: Iterable, tolerance: float = 4.0,
                    input_hw: Optional[Tuple[int, int]] = None) -> Tuple[float, Dict]:
    """``eval_step(batch) -> (loss, coor_inpaint (B, L, 2))``; ``input_hw``
    is the resolution the loader normalised the coordinates by
    (``SplitIndex.input_hw``; default HEIGHT x WIDTH). Returns (mean batch
    loss, {eval type: metrics dict})."""
    hgt, wdt = input_hw if input_hw is not None else (HEIGHT, WIDTH)
    losses = []
    confusion = {t: np.zeros(5) for t in INPAINTNET_EVAL_TYPES}

    def centers(c):
        c = np.asarray(_host(c))
        return (c[..., 0] * wdt).astype(np.int64), (c[..., 1] * hgt).astype(np.int64)

    for batch in loader:
        loss, coor_inpaint = eval_step(batch)
        losses.append(float(loss))
        keep = _dedup_mask(np.asarray(_host(batch["id"])))
        ci, cg, cp = (centers(c) for c in (coor_inpaint, batch["coor"], batch["coor_pred"]))
        pairs = {"inpaint": (ci, cg), "reconstruct": (ci, cp), "baseline": (cp, cg)}
        for name, ((cxp, cyp), (cxt, cyt)) in pairs.items():
            types = classify_detections(cxp, cyp, cxt, cyt, tolerance)
            confusion[name] += confusion_from_types(types[keep])
    res = {t: metrics_dict(confusion[t]) for t in INPAINTNET_EVAL_TYPES}
    return float(np.mean(losses)) if losses else 0.0, res


def _host(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else a
