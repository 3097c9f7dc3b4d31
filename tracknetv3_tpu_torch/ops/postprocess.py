"""Trajectory post-processing: inpaint-mask generation and linear baseline.

A copy of the JAX package's ``ops/postprocess.py`` (host-only numpy).
Host-side sequential logic (tiny, O(T) over the trajectory - not worth a
device program):

- ``generate_inpaint_mask``: scan the predicted visibility sequence for
  1 -> 0...0 -> 1 gaps and mark a gap for inpainting only when the flanking
  y-coordinates EXCEED the camera-exit threshold ``th_h`` (image y grows
  downward, so small flanking y = ball near the top edge = it likely flew
  out of the camera view, a real absence that must NOT be inpainted).
  Reference contract: test.py:223-258.

- ``linear_interp``: replace masked gap values with linear interpolation
  between the flanking visible points (edge gaps held constant) - the
  non-learned InpaintNet baseline. Reference contract: test.py:260-286.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def generate_inpaint_mask(pred_dict: Dict, th_h: float = 30.0) -> List[int]:
    """Mark occlusion gaps in a predicted trajectory for inpainting."""
    y = np.asarray(pred_dict["Y"])
    vis = np.asarray(pred_dict["Visibility"])
    mask = np.zeros_like(y, dtype=np.int64)
    n = len(vis)
    i = 0  # gap start (first invisible frame)
    j = 0  # gap end (first visible frame after the gap)
    while j < n:
        while i < n - 1 and vis[i] == 1:
            i += 1
        j = i
        while j < n - 1 and vis[j] == 0:
            j += 1
        if j == i:
            break
        elif i == 0 and y[j] > th_h:
            # Trajectory starts invisible: inpaint the leading gap.
            mask[:j] = 1
        elif (i > 1 and y[i - 1] > th_h) and (j < n and y[j] > th_h):
            mask[i:j] = 1
        else:
            # Ball left the camera view; leave the gap alone.
            pass
        i = j
    return mask.tolist()


def linear_interp(target: Sequence[float], inpaint_mask: Sequence[int]) -> np.ndarray:
    """Linear interpolation over masked runs (edge runs held constant)."""
    assert len(target) == len(inpaint_mask), "target/mask length mismatch"
    target = np.array(target, dtype=np.float64)
    mask = np.asarray(inpaint_mask)
    n = len(mask)
    i = 0  # run start
    j = 0  # run end
    while j < n:
        while i < n - 1 and mask[i] == 0:
            i += 1
        j = i
        while j < n - 1 and mask[j] == 1:
            j += 1
        if j == i:
            break
        x = np.linspace(0, 1, j - i)
        if i == 0:
            fp = [target[j], target[j]]
        elif j == n - 1:
            fp = [target[i - 1], target[i - 1]]
        else:
            fp = [target[i - 1], target[j]]
        target[i:j] = np.interp(x, [0, 1], fp)
        i = j
    return target
