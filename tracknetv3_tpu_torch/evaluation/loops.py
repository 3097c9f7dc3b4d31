"""Validation loops of both models, in one process or several.

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

Several processes (``process_id`` / ``process_count`` > 1, under the
caller's ``torch.distributed`` group): each evaluates the batches ``i`` with
``i % process_count == process_id`` and keeps a loss slot per batch of the
loader; ``_merge_across_processes`` then gathers the slots and the integer
confusions, so every process ends with the metrics of a one-process run,
bit for bit: each slot has one contributor and the mean is taken in global
batch order.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import HEIGHT, INPAINTNET_EVAL_TYPES, WIDTH
from ..ops.detect import decode_heatmaps, decode_heatmaps_exact, decode_heatmaps_host
from ..parallel.processes import host_group
from .metrics import classify_detections, confusion_from_types, gt_center_from_label, metrics_dict


def _dedup_mask(ids: np.ndarray) -> np.ndarray:
    """True where a frame counts: after the first consecutive repeat of a
    (rally, frame) id within a sample (padding), the rest is dropped."""
    same = np.all(ids[:, 1:] == ids[:, :-1], axis=-1)
    keep = np.concatenate([np.ones((ids.shape[0], 1), bool), ~same], axis=1)
    return np.logical_and.accumulate(keep, axis=1)


def _merge_across_processes(loss_slots: List[float], confusions: np.ndarray,
                            process_id: int, process_count: int):
    """(loss slots, confusions) of all processes of the default group, the
    same on each: slot ``i`` from the process that evaluated batch ``i``
    (``i % process_count``), the confusions summed. ``loss_slots`` holds a
    slot per batch of the loader (0 where another process evaluates it);
    ``confusions`` integer counts in any float array. A collective: every
    process calls it with as many slots and the same confusion shape.

    The transport is exact: the slots travel as float64 and the counts as
    int64, in two all-gathers of host tensors over gloo (``host_group``).
    The JAX package sends float32 bits as int32 only because its all-gather
    would downcast float64; gloo gathers either type unchanged."""
    import torch.distributed as dist

    group = host_group()
    if (dist.get_world_size(group), dist.get_rank(group)) != (process_count, process_id):
        raise ValueError(f"process {process_id} of {process_count} is rank "
                         f"{dist.get_rank(group)} of a group of {dist.get_world_size(group)}")
    counts = np.asarray(confusions).astype(np.int64)
    assert np.array_equal(counts, confusions), "confusion counts not integral"
    local = torch.tensor(loss_slots, dtype=torch.float64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(process_count)]
    dist.all_gather(sizes, torch.tensor([local.numel()]), group=group)
    if len({int(n) for n in sizes}) != 1:
        raise ValueError(f"the processes' loaders differ in length: {[int(n) for n in sizes]}")
    slots = [torch.empty_like(local) for _ in range(process_count)]
    dist.all_gather(slots, local, group=group)
    gathered = [torch.empty(counts.size, dtype=torch.int64) for _ in range(process_count)]
    dist.all_gather(gathered, torch.from_numpy(counts.ravel()), group=group)
    merged = [float(slots[i % process_count][i]) for i in range(local.numel())]
    total = torch.stack(gathered).sum(0).numpy().reshape(counts.shape)
    return merged, total.astype(np.float64)


def _mean(loss_slots: List[float]) -> float:
    return float(np.mean(loss_slots)) if loss_slots else 0.0


def eval_tracknet(eval_step: Callable, loader: Iterable, tolerance: float = 4.0,
                  exact_decode: Union[bool, str] = False, process_id: int = 0,
                  process_count: int = 1) -> Tuple[float, Dict]:
    """``eval_step(batch) -> (loss, probs (B, H, W, L))``; ``loader`` yields
    batches whose ``cxcy`` and ``id`` are host numpy arrays (or tensors).
    ``exact_decode``: False, the serving decoder (peak blob); True (or
    ``"device"``), the largest-bbox-area rule on the device; ``"host"``, the
    same rule on the host. With ``process_count`` > 1 this process evaluates
    its round-robin share of the batches and the results are merged (module
    docstring). Returns (mean batch loss, metrics dict)."""
    loss_slots: List[float] = []  # one per batch of the loader
    confusion = np.zeros(5)
    for i, batch in enumerate(loader):
        if i % process_count != process_id:
            loss_slots.append(0.0)
            continue
        loss, probs = eval_step(batch)
        loss_slots.append(float(loss))
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
    if process_count > 1:
        loss_slots, confusion = _merge_across_processes(loss_slots, confusion, process_id,
                                                        process_count)
    return _mean(loss_slots), metrics_dict(confusion)


def eval_inpaintnet(eval_step: Callable, loader: Iterable, tolerance: float = 4.0,
                    input_hw: Optional[Tuple[int, int]] = None, process_id: int = 0,
                    process_count: int = 1) -> Tuple[float, Dict]:
    """``eval_step(batch) -> (loss, coor_inpaint (B, L, 2))``; ``input_hw``
    is the resolution the loader normalised the coordinates by
    (``SplitIndex.input_hw``; default HEIGHT x WIDTH). ``process_id`` /
    ``process_count`` as in ``eval_tracknet``. Returns (mean batch loss,
    {eval type: metrics dict})."""
    hgt, wdt = input_hw if input_hw is not None else (HEIGHT, WIDTH)
    loss_slots: List[float] = []  # one per batch of the loader
    confusion = {t: np.zeros(5) for t in INPAINTNET_EVAL_TYPES}

    def centers(c):
        c = np.asarray(_host(c))
        return (c[..., 0] * wdt).astype(np.int64), (c[..., 1] * hgt).astype(np.int64)

    for i, batch in enumerate(loader):
        if i % process_count != process_id:
            loss_slots.append(0.0)
            continue
        loss, coor_inpaint = eval_step(batch)
        loss_slots.append(float(loss))
        keep = _dedup_mask(np.asarray(_host(batch["id"])))
        ci, cg, cp = (centers(c) for c in (coor_inpaint, batch["coor"], batch["coor_pred"]))
        pairs = {"inpaint": (ci, cg), "reconstruct": (ci, cp), "baseline": (cp, cg)}
        for name, ((cxp, cyp), (cxt, cyt)) in pairs.items():
            types = classify_detections(cxp, cyp, cxt, cyt, tolerance)
            confusion[name] += confusion_from_types(types[keep])
    if process_count > 1:
        stacked = np.stack([confusion[t] for t in INPAINTNET_EVAL_TYPES])
        loss_slots, stacked = _merge_across_processes(loss_slots, stacked, process_id,
                                                      process_count)
        confusion = {t: stacked[k] for k, t in enumerate(INPAINTNET_EVAL_TYPES)}
    res = {t: metrics_dict(confusion[t]) for t in INPAINTNET_EVAL_TYPES}
    return _mean(loss_slots), res


def _host(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else a
