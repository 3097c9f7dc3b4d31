"""Frame-classification metrics: 5-way confusion and summary scores.

Copy of the JAX package's ``evaluation/metrics.py`` (host numpy):
  TP  - both detected, center distance <= tolerance
  TN  - neither detected
  FP1 - both detected but distance > tolerance
  FP2 - predicted a ball where ground truth has none
  FN  - missed an existing ball
  accuracy = (TP+TN)/total, precision = TP/(TP+FP1+FP2),
  recall = TP/(TP+FN), f1 = 2PR/(P+R), miss_rate = FN/(TP+FN)
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from ..config import HEIGHT, PRED_TYPES, PRED_TYPES_MAP, SIGMA, WIDTH


def get_metric(TP, TN, FP1, FP2, FN) -> Tuple[float, float, float, float, float]:
    """accuracy, precision, recall, f1, miss_rate."""
    total = TP + TN + FP1 + FP2 + FN
    accuracy = (TP + TN) / total if total > 0 else 0
    precision = TP / (TP + FP1 + FP2) if (TP + FP1 + FP2) > 0 else 0
    recall = TP / (TP + FN) if (TP + FN) > 0 else 0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) > 0 else 0
    miss_rate = FN / (TP + FN) if (TP + FN) > 0 else 0
    return accuracy, precision, recall, f1, miss_rate


def metrics_dict(confusion: np.ndarray) -> Dict[str, float]:
    TP, TN, FP1, FP2, FN = (float(c) for c in confusion)
    accuracy, precision, recall, f1, miss_rate = get_metric(TP, TN, FP1, FP2, FN)
    return {
        "TP": TP, "TN": TN, "FP1": FP1, "FP2": FP2, "FN": FN,
        "accuracy": accuracy, "precision": precision, "recall": recall,
        "f1": f1, "miss_rate": miss_rate,
    }


def classify_detections(cx_pred, cy_pred, cx_true, cy_true, tolerance: float = 4.0) -> np.ndarray:
    """5-way type per frame from integer input-space centers; a detection
    exists iff max(cx, cy) > 0."""
    cx_pred = np.asarray(cx_pred, np.int64)
    cy_pred = np.asarray(cy_pred, np.int64)
    cx_true = np.asarray(cx_true, np.int64)
    cy_true = np.asarray(cy_true, np.int64)
    p = np.maximum(cx_pred, cy_pred) > 0
    t = np.maximum(cx_true, cy_true) > 0
    dist = np.sqrt((cx_pred - cx_true) ** 2.0 + (cy_pred - cy_true) ** 2.0)
    types = np.empty(cx_pred.shape, np.int64)
    types[~p & ~t] = PRED_TYPES_MAP["TN"]
    types[p & ~t] = PRED_TYPES_MAP["FP2"]
    types[~p & t] = PRED_TYPES_MAP["FN"]
    both = p & t
    types[both & (dist > tolerance)] = PRED_TYPES_MAP["FP1"]
    types[both & (dist <= tolerance)] = PRED_TYPES_MAP["TP"]
    return types


def confusion_from_types(types: np.ndarray) -> np.ndarray:
    """Count [TP, TN, FP1, FP2, FN] from a type array."""
    counts = np.bincount(np.asarray(types, np.int64).ravel(), minlength=len(PRED_TYPES))
    return counts[: len(PRED_TYPES)].astype(np.float64)


def gt_center_from_label(x, y, w_scaler: float, h_scaler: float, sigma: float = SIGMA,
                         width: int = WIDTH, height: int = HEIGHT):
    """Input-space GT center as decoding the GT disk heatmap yields it: the
    disk is clipped at the image border, x-extent
    [max(0, cx-r), min(W-1, cx+r)] with r = floor(sigma), center
    xmin + extent // 2."""
    cx = (np.asarray(x, np.float64) / w_scaler).astype(np.int64)
    cy = (np.asarray(y, np.float64) / h_scaler).astype(np.int64)
    r = int(math.floor(sigma))
    xmin = np.clip(cx - r, 0, None)
    xmax = np.minimum(cx + r, width - 1)
    ymin = np.clip(cy - r, 0, None)
    ymax = np.minimum(cy + r, height - 1)
    out_cx = xmin + (xmax - xmin + 1) // 2
    out_cy = ymin + (ymax - ymin + 1) // 2
    invisible = (cx == 0) & (cy == 0)
    return np.where(invisible, 0, out_cx), np.where(invisible, 0, out_cy)
