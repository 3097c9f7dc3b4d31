"""Heatmap -> ball coordinate decoding, batched torch ops, and the host oracle.

The JAX package's ``ops/detect.py`` in torch, equal to it bit for bit in the
integer outputs.

``decode_heatmaps`` (the serving decoder, the peak blob):

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

``decode_heatmaps_exact`` (the evaluation rule: the blob of the largest
bounding-box area, ties to the blob whose first pixel comes first in raster
order) extracts one blob per step in a lockstep loop over the frames: seed
at the brightest pixel still unclaimed, fill crop-locally for ``crop``
steps, then dilate at full resolution while the region grows, score it by
(area, -first raster index) and remove it. A frame updates only while it
has pixels left, as under the JAX function's ``vmap``; the loops end on a
host check each step, so the result does not depend on ``crop``.

``decode_heatmaps_host`` is the same rule on the host (``native_ccl``'s
library, else ``scipy.ndimage``): the oracle the device rule is held to.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_BIG = 1 << 30


def _dilate3x3(region: torch.Tensor) -> torch.Tensor:
    """8-connectivity binary dilation of (n, h, w) 0/1 maps."""
    return F.max_pool2d(region[:, None], 3, stride=1, padding=1)[:, 0]


def _bbox_of(region: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(x, y, w, h) bounding box of each (h, w) 0/1 map of ``region`` (n, h,
    w), in the map's coordinates; zeros where the map is empty."""
    dev = region.device
    rows = region.amax(dim=2) > 0  # (n, h)
    cols = region.amax(dim=1) > 0  # (n, w)
    ri = torch.arange(region.shape[1], device=dev)
    ci = torch.arange(region.shape[2], device=dev)
    big = torch.tensor(_BIG, device=dev)
    neg = torch.tensor(-1, device=dev)
    ymin = torch.where(rows, ri, big).amin(dim=1)
    ymax = torch.where(rows, ri, neg).amax(dim=1)
    xmin = torch.where(cols, ci, big).amin(dim=1)
    xmax = torch.where(cols, ci, neg).amax(dim=1)
    empty = ymax < 0
    zero = torch.zeros_like(ymin)
    return (torch.where(empty, zero, xmin), torch.where(empty, zero, ymin),
            torch.where(empty, zero, xmax - xmin + 1), torch.where(empty, zero, ymax - ymin + 1))


def _crop_windows(maps: torch.Tensor, seed_r, seed_c, crop: int):
    """The ``crop`` x ``crop`` window of each map around its seed, clipped
    into the frame: (windows, r0, c0, index of the window in the maps)."""
    n, h, w = maps.shape
    dev = maps.device
    r0 = (seed_r - crop // 2).clamp(0, h - crop)
    c0 = (seed_c - crop // 2).clamp(0, w - crop)
    ar = torch.arange(crop, device=dev)
    where = (torch.arange(n, device=dev)[:, None, None], (r0[:, None] + ar)[:, :, None],
             (c0[:, None] + ar)[:, None, :])
    return maps[where], r0, c0, where


def _outputs(lead, x, y, bw, bh, conf, valid) -> Dict[str, torch.Tensor]:
    """The decode dict: zeros where ``valid`` is False, ``vis`` from the
    center, integer fields int32."""
    zero = torch.zeros_like(x)
    cx = torch.where(valid, x + bw // 2, zero)
    cy = torch.where(valid, y + bh // 2, zero)
    x, y = torch.where(valid, x, zero), torch.where(valid, y, zero)
    bw, bh = torch.where(valid, bw, zero), torch.where(valid, bh, zero)
    conf = torch.where(valid, conf, torch.zeros_like(conf))
    vis = (cx != 0) | (cy != 0)
    i32 = torch.int32
    return {
        "cx": cx.to(i32).reshape(lead),
        "cy": cy.to(i32).reshape(lead),
        "vis": vis.to(i32).reshape(lead),
        "conf": conf.reshape(lead),
        "bbox": torch.stack([x, y, bw, bh], dim=-1).to(i32).reshape(lead + (4,)),
    }


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
    crop = min(crop, h, w)

    idx = flat.reshape(n, -1).argmax(dim=1)
    seed_r, seed_c = idx // w, idx % w
    win, r0, c0, (_, rows, cols) = _crop_windows(flat, seed_r, seed_c, crop)
    mask = (win > threshold).float()
    has_any = flat.reshape(n, -1).amax(dim=1) > threshold
    region = torch.zeros_like(win)
    region[torch.arange(n, device=flat.device), seed_r - r0, seed_c - c0] = 1.0
    region = region * mask  # a sub-threshold argmax leaves the map empty
    for _ in range(min(max_iters, crop)):
        region = torch.minimum(_dilate3x3(region), mask)

    x, y, bw, bh = _bbox_of(region)
    x, y = x + c0, y + r0
    in_bbox = (
        (rows >= y[:, None, None]) & (rows < (y + bh)[:, None, None])
        & (cols >= x[:, None, None]) & (cols < (x + bw)[:, None, None])
    )
    conf = torch.where(in_bbox, win, torch.zeros_like(win)).amax(dim=(1, 2))
    return _outputs(lead, x, y, bw, bh, conf, has_any)


def _better(area, first, best_area, best_first) -> torch.Tensor:
    """The exact rule's order: a larger bounding-box area wins, and on equal
    areas the blob whose first pixel comes first in raster order."""
    return (area > best_area) | ((area == best_area) & (first < best_first))


def _expand(region: torch.Tensor, remaining: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Full-resolution fill of each active frame's region inside
    ``remaining`` while it grows: its whole 8-connected component, whatever
    its size. One host check a step."""
    growing = active
    count = region.flatten(1).sum(dim=1)
    while bool(growing.any()):
        new = torch.minimum(_dilate3x3(region), remaining)
        new_count = new.flatten(1).sum(dim=1)
        region = torch.where(growing[:, None, None], new, region)
        growing = growing & (new_count > count)
        count = new_count
    return region


def decode_heatmaps_exact(
    probs: torch.Tensor, threshold: float = 0.5, crop: int = 96
) -> Dict[str, torch.Tensor]:
    """Exact largest-bbox-area decode of heatmaps of any leading shape
    ``S + (H, W)``, the same dict as :func:`decode_heatmaps`: the JAX
    package's ``decode_heatmaps_exact`` (``ops/detect.py:283``) and equal to
    :func:`decode_heatmaps_host` on every map. ``crop`` sizes the crop-local
    fill only. Costs one host check per extracted blob and per full-resolution
    dilation step (the loops' bounds depend on the data)."""
    lead = probs.shape[:-2]
    h, w = probs.shape[-2:]
    flat = probs.reshape(-1, h, w).float()
    n = flat.shape[0]
    dev = flat.device
    crop = min(crop, h, w)
    raster = torch.arange(h * w, device=dev).reshape(h, w)
    n_idx = torch.arange(n, device=dev)

    remaining = (flat > threshold).float()
    best_area = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_first = torch.full((n,), _BIG, dtype=torch.int64, device=dev)
    best_bbox = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    while True:
        active = remaining.flatten(1).amax(dim=1) > 0
        if not bool(active.any()):
            break
        masked = torch.where(remaining > 0, flat, torch.tensor(-torch.inf, device=dev))
        idx = masked.flatten(1).argmax(dim=1)
        seed_r, seed_c = idx // w, idx % w
        win, r0, c0, where = _crop_windows(remaining, seed_r, seed_c, crop)
        region = torch.zeros_like(win)
        # a frame with nothing left seeds nothing (its argmax is index 0)
        region[n_idx, seed_r - r0, seed_c - c0] = active.float()
        for _ in range(crop):
            region = torch.minimum(_dilate3x3(region), win)
        full = torch.zeros_like(remaining)
        full[where] = region
        full = _expand(full, remaining, active)

        x, y, bw, bh = _bbox_of(full)
        area = bw * bh
        first = torch.where(full > 0, raster, _BIG).flatten(1).amin(dim=1)
        better = active & _better(area, first, best_area, best_first)
        best_area = torch.where(better, area, best_area)
        best_first = torch.where(better, first, best_first)
        best_bbox = torch.where(better[:, None], torch.stack([x, y, bw, bh], dim=1), best_bbox)
        remaining = remaining * (1.0 - full)

    x, y, bw, bh = best_bbox.unbind(dim=1)
    in_bbox = (
        (raster // w >= y[:, None, None]) & (raster // w < (y + bh)[:, None, None])
        & (raster % w >= x[:, None, None]) & (raster % w < (x + bw)[:, None, None])
    )
    conf = torch.where(in_bbox, flat, torch.zeros_like(flat)).amax(dim=(1, 2))
    return _outputs(lead, x, y, bw, bh, conf, best_area > 0)


def host_backend(use_native: bool = True) -> str:
    """Which library ``decode_heatmaps_host`` runs: ``"native"`` (the
    connected-components library of ``native/``, built by ``make``) or
    ``"scipy"`` (where it does not build, or ``use_native`` is False)."""
    from .. import native_ccl

    return "native" if use_native and native_ccl.available() else "scipy"


def decode_heatmaps_host(
    probs: np.ndarray, threshold: float = 0.5, use_native: bool = True
) -> Dict[str, np.ndarray]:
    """The exact largest-bbox-area rule on the host, numpy in and out (the
    JAX package's ``decode_heatmaps_host``): the native connected-components
    library where it builds (``native_ccl`` says on stderr which ran), else
    ``scipy.ndimage``."""
    if use_native:
        from ..native_ccl import decode_heatmaps_native

        out = decode_heatmaps_native(np.asarray(probs, np.float32), threshold)
        if out is not None:
            return out

    from scipy import ndimage

    probs = np.asarray(probs)
    lead = probs.shape[:-2]
    h, w = probs.shape[-2:]
    flat = probs.reshape((-1, h, w))
    n = flat.shape[0]
    cx = np.zeros(n, np.int32)
    cy = np.zeros(n, np.int32)
    vis = np.zeros(n, np.int32)
    conf = np.zeros(n, np.float32)
    bbox = np.zeros((n, 4), np.int32)
    structure = np.ones((3, 3), dtype=bool)  # 8-connectivity
    for i in range(n):
        mask = flat[i] > threshold
        if not mask.any():
            continue
        labels, _ = ndimage.label(mask, structure=structure)
        best_area, best = -1, None
        for sl in ndimage.find_objects(labels):  # labels in raster order of first pixels
            bh_, bw_ = sl[0].stop - sl[0].start, sl[1].stop - sl[1].start
            if bh_ * bw_ > best_area:
                best_area = bh_ * bw_
                best = (sl[1].start, sl[0].start, bw_, bh_)
        x, y, bw_, bh_ = best
        cx[i] = x + bw_ // 2
        cy[i] = y + bh_ // 2
        vis[i] = 0 if (cx[i] == 0 and cy[i] == 0) else 1
        conf[i] = float(flat[i][y : y + bh_, x : x + bw_].max())
        bbox[i] = (x, y, bw_, bh_)
    return {
        "cx": cx.reshape(lead),
        "cy": cy.reshape(lead),
        "vis": vis.reshape(lead),
        "conf": conf.reshape(lead),
        "bbox": bbox.reshape(lead + (4,)),
    }
