"""Heatmap -> ball coordinate decoding, batched torch ops.

Same function as the JAX package's ``ops/detect.py::decode_heatmaps``, and
equal to it bit for bit in the integer outputs:

1. seed at the global argmax of each (H, W) map (first index on ties);
2. cut a ``crop = min(64, H, W)`` square window around the seed, clipped
   into the frame;
3. flood-fill from the seed inside the window: ``min(max_iters, crop)``
   steps of 3x3 max-pool dilation AND-ed with the ``> threshold`` mask
   (8-connectivity; a fixed step count, so no host sync);
4. read off the region's bounding box, the center ``x + w // 2``,
   ``y + h // 2``, and the confidence as the max probability inside the
   box; a map with nothing above the threshold decodes to zeros, and
   ``vis`` is ``(cx, cy) != (0, 0)``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def decode_heatmaps(
    probs: torch.Tensor, threshold: float = 0.5, max_iters: int = 64, crop: int = 64
) -> Dict[str, torch.Tensor]:
    """Decode heatmaps of any leading shape ``S + (H, W)``.

    Returns cx, cy, vis (int32, S), conf (float32, S) and bbox
    (int32, S + (4,)) in (x, y, w, h) order.
    """
    lead = probs.shape[:-2]
    h, w = probs.shape[-2:]
    flat = probs.reshape(-1, h, w).float()
    n = flat.shape[0]
    dev = flat.device
    crop = min(crop, h, w)

    idx = flat.reshape(n, -1).argmax(dim=1)
    seed_r, seed_c = idx // w, idx % w
    r0 = (seed_r - crop // 2).clamp(0, h - crop)
    c0 = (seed_c - crop // 2).clamp(0, w - crop)
    ar = torch.arange(crop, device=dev)
    rows = r0[:, None] + ar  # (n, crop)
    cols = c0[:, None] + ar
    win = flat[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]

    mask = (win > threshold).float()
    has_any = flat.reshape(n, -1).amax(dim=1) > threshold
    region = torch.zeros_like(win)
    region[torch.arange(n, device=dev), seed_r - r0, seed_c - c0] = 1.0
    region = region * mask  # a sub-threshold argmax leaves the map empty
    for _ in range(min(max_iters, crop)):
        grown = F.max_pool2d(region[:, None], 3, stride=1, padding=1)[:, 0]
        region = torch.minimum(grown, mask)

    big = torch.tensor(1 << 30, device=dev)
    neg = torch.tensor(-1, device=dev)
    any_row = region.amax(dim=2) > 0  # (n, crop)
    any_col = region.amax(dim=1) > 0
    ymin = torch.where(any_row, ar, big).amin(dim=1)
    ymax = torch.where(any_row, ar, neg).amax(dim=1)
    xmin = torch.where(any_col, ar, big).amin(dim=1)
    xmax = torch.where(any_col, ar, neg).amax(dim=1)
    empty = ymax < 0
    zero = torch.zeros_like(ymin)
    x = torch.where(empty, zero, xmin) + c0
    y = torch.where(empty, zero, ymin) + r0
    bw = torch.where(empty, zero, xmax - xmin + 1)
    bh = torch.where(empty, zero, ymax - ymin + 1)

    in_bbox = (
        (rows[:, :, None] >= y[:, None, None])
        & (rows[:, :, None] < (y + bh)[:, None, None])
        & (cols[:, None, :] >= x[:, None, None])
        & (cols[:, None, :] < (x + bw)[:, None, None])
    )
    conf = torch.where(in_bbox, win, torch.zeros_like(win)).amax(dim=(1, 2))

    cx = torch.where(has_any, x + bw // 2, zero)
    cy = torch.where(has_any, y + bh // 2, zero)
    x, y = torch.where(has_any, x, zero), torch.where(has_any, y, zero)
    bw, bh = torch.where(has_any, bw, zero), torch.where(has_any, bh, zero)
    conf = torch.where(has_any, conf, torch.zeros_like(conf))
    vis = (cx != 0) | (cy != 0)
    i32 = torch.int32
    return {
        "cx": cx.to(i32).reshape(lead),
        "cy": cy.to(i32).reshape(lead),
        "vis": vis.to(i32).reshape(lead),
        "conf": conf.reshape(lead),
        "bbox": torch.stack([x, y, bw, bh], dim=-1).to(i32).reshape(lead + (4,)),
    }
