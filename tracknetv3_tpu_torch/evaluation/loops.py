"""Validation loop for TrackNet: WBCE loss + 5-way confusion.

The port of the JAX package's ``evaluation/loops.py::eval_tracknet``
(single process, default decoder): the eval step's heatmaps are decoded on
the device for the whole batch, and ground-truth centers come from the
analytic disk center (``metrics.gt_center_from_label``).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np

from ..ops.detect import decode_heatmaps
from .metrics import classify_detections, confusion_from_types, gt_center_from_label, metrics_dict


def _dedup_mask(ids: np.ndarray) -> np.ndarray:
    """True where a frame counts: after the first consecutive repeat of a
    (rally, frame) id within a sample (padding), the rest is dropped."""
    same = np.all(ids[:, 1:] == ids[:, :-1], axis=-1)
    keep = np.concatenate([np.ones((ids.shape[0], 1), bool), ~same], axis=1)
    return np.logical_and.accumulate(keep, axis=1)


def eval_tracknet(eval_step: Callable, loader: Iterable, tolerance: float = 4.0) -> Tuple[float, Dict]:
    """``eval_step(batch) -> (loss, probs (B, H, W, L))``; ``loader`` yields
    batches whose ``cxcy`` and ``id`` are host numpy arrays (or tensors).
    Returns (mean batch loss, metrics dict)."""
    losses = []
    confusion = np.zeros(5)
    for batch in loader:
        loss, probs = eval_step(batch)
        losses.append(float(loss))
        dec = decode_heatmaps(probs.movedim(-1, 1))  # (B, L, H, W)
        cx_p = dec["cx"].cpu().numpy()
        cy_p = dec["cy"].cpu().numpy()
        cxcy = np.asarray(_host(batch["cxcy"]))
        cx_t, cy_t = gt_center_from_label(cxcy[..., 0], cxcy[..., 1], 1.0, 1.0)
        types = classify_detections(cx_p, cy_p, cx_t, cy_t, tolerance)
        keep = _dedup_mask(np.asarray(_host(batch["id"])))
        confusion += confusion_from_types(types[keep])
    return float(np.mean(losses)) if losses else 0.0, metrics_dict(confusion)


def _host(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else a
