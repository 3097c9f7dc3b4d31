"""Shuttlecock Trajectory Dataset: window index, frame cache, batch loader.

Copy of the heatmap- and coordinate-mode parts of the JAX package's
``data/dataset.py``, host-side numpy, with the same on-disk caches so a data
directory prepared by either package serves both:

- ``img_config_{H}x{W}_{split}.npz``: per-rally original (w, h) and scale;
- ``data_l{L}_s{S}_{mode}_{split}.npz``: the split's sliding-window index,
  ``heatmap`` (TrackNet, from the label CSVs) or ``coordinate`` (InpaintNet,
  from the ``predicted_csv`` files);
- ``{rally}/cache_{H}x{W}_{tag}.npz``: a rally's frames resized to the
  model resolution once, as uint8 (plus the resized median in concat
  mode).

``HeatmapBatchLoader`` shuffles with ``np.random.default_rng(seed)`` exactly
as the JAX loader does, so both yield the same batches: plain ones,
segmented ones (``segment_windows`` > 1: each segment's unique frames once,
expanded into windows on the device) and frame-mixup ones (``frame_alpha``
> 0: the host blend plan of ``frame_mixup.plan_frame_mixup``).
``ResidentHeatmapLoader`` puts the split's frames on the device once and
yields flat frame indices. ``CoordinateBatchLoader`` yields InpaintNet's
normalised trajectories with the JAX loader's shuffle. PIL is imported only
where a cache is missing; CSVs are read without pandas.

Several processes (``process_id`` / ``process_count`` > 1) load as the JAX
loaders do: every process draws the same global batch order from the same
seed and assembles only its contiguous 1/``process_count`` slice of each
batch's rows (of each batch's segments, for segmented batches), which needs
full batches (``drop_last``) and a batch size the process count divides.
Frame mixup draws the plans of its own rows only, from its own generator.
Resident frames over several processes or on a mesh are placed as the JAX
loader places them (``ResidentHeatmapLoader``: replicated, or sharded over
the holders).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import HEIGHT, IMG_FORMAT, WIDTH
from ..ops.shift_copy import check_starts
from ..parallel.mesh import FrameShards
from ..utils.io import (
    get_rally_dirs,
    label_csv_path,
    load_median_for_rally,
    parse_rally_dir,
    png_size,
    read_csv_columns,
)
from .frame_mixup import plan_frame_mixup


def _slide_windows(n: int, seq_len: int, sliding_step: int, padding: bool) -> List[List[int]]:
    """Frame-index windows: windows shorter than seq_len are dropped unless
    ``padding``, which repeats the last valid index."""
    windows = []
    for i in range(0, n, sliding_step):
        idx = list(range(i, min(i + seq_len, n)))
        if len(idx) < seq_len:
            if padding and idx:
                idx = idx + [idx[-1]] * (seq_len - len(idx))
            else:
                continue
        windows.append(idx)
    return windows


def build_rally_heatmap_index(
    data_dir: str, rally_dir: str, rally_i: int, seq_len: int, sliding_step: int,
    padding: bool = False,
) -> Dict[str, np.ndarray]:
    """Heatmap-mode window index of one rally (id, frame ids, coor, vis)."""
    match_dir, rally_id = parse_rally_dir(rally_dir)
    cols = read_csv_columns(label_csv_path(match_dir, rally_id), ("Frame", "Visibility", "X", "Y"))
    frames = cols["Frame"]
    x = cols["X"].astype(np.float32)
    y = cols["Y"].astype(np.float32)
    v = cols["Visibility"].astype(np.float32)

    padding = padding and sliding_step == seq_len
    windows = _slide_windows(len(frames), seq_len, sliding_step, padding)
    if not windows:
        return {
            "id": np.zeros((0, seq_len, 2), np.int32),
            "frame_id": np.zeros((0, seq_len), np.int64),
            "coor": np.zeros((0, seq_len, 2), np.float32),
            "vis": np.zeros((0, seq_len), np.float32),
        }
    w = np.asarray(windows)
    ids = np.stack([np.full_like(w, rally_i), w], axis=-1).astype(np.int32)
    return {
        "id": ids,
        "frame_id": frames[w].astype(np.int64),
        "coor": np.stack([x[w], y[w]], axis=-1),
        "vis": v[w],
    }


# the columns of a predicted_csv file (generate_mask_data's output)
COORDINATE_COLUMNS = ("Visibility_GT", "X_GT", "Y_GT", "Visibility", "X", "Y", "Inpaint_Mask")


def build_rally_coordinate_index(
    data_dir: str, rally_dir: str, rally_i: int, seq_len: int, sliding_step: int,
    padding: bool = False,
) -> Dict[str, np.ndarray]:
    """Coordinate-mode window index of one rally (InpaintNet data) from its
    ``predicted_csv/{rally}_ball.csv``: id, ground-truth and predicted
    coordinates, their visibilities and the inpaint mask."""
    match_dir, rally_id = parse_rally_dir(rally_dir)
    csv_file = os.path.join(match_dir, "predicted_csv", f"{rally_id}_ball.csv")
    if not os.path.exists(csv_file):
        raise FileNotFoundError(f"{csv_file} does not exist")
    cols = read_csv_columns(csv_file, COORDINATE_COLUMNS)

    padding = padding and sliding_step == seq_len
    windows = _slide_windows(len(cols["X"]), seq_len, sliding_step, padding)
    if not windows:
        z = np.zeros((0, seq_len), np.float32)
        return {
            "id": np.zeros((0, seq_len, 2), np.int32),
            "coor": np.zeros((0, seq_len, 2), np.float32),
            "coor_pred": np.zeros((0, seq_len, 2), np.float32),
            "vis": z, "pred_vis": z, "inpaint_mask": z,
        }
    w = np.asarray(windows)
    ids = np.stack([np.full_like(w, rally_i), w], axis=-1).astype(np.int32)

    def col(name):
        return cols[name].astype(np.float32)[w]

    return {
        "id": ids,
        "coor": np.stack([col("X_GT"), col("Y_GT")], axis=-1),
        "coor_pred": np.stack([col("X"), col("Y")], axis=-1),
        "vis": col("Visibility_GT"),
        "pred_vis": col("Visibility"),
        "inpaint_mask": col("Inpaint_Mask"),
    }


def _atomic_savez(path: str, **arrays) -> None:
    """np.savez through a temp file + os.replace: readers never see a
    partial cache."""
    tmp = f"{path}.tmp{os.getpid()}.npz"  # must end in .npz for np.savez
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


@dataclass
class SplitIndex:
    """Window index over a split + image geometry."""

    data: Dict[str, np.ndarray]
    rally_dirs: List[str]  # absolute, indexed by rally_i
    img_shape: np.ndarray  # (num_rally, 2) original (w, h) per rally
    img_scaler: np.ndarray  # (num_rally, 2) (w/input_w, h/input_h)
    input_hw: Tuple[int, int] = (HEIGHT, WIDTH)

    def __len__(self):
        return len(self.data["id"])


def _rally_geometry(rally_dirs: List[str], input_hw: Tuple[int, int]):
    shapes, scalers = [], []
    for rd in rally_dirs:
        w, h = png_size(os.path.join(rd, f"0.{IMG_FORMAT}"))
        shapes.append((w, h))
        scalers.append((w / input_hw[1], h / input_hw[0]))
    return np.asarray(shapes, np.float64), np.asarray(scalers, np.float64)


def build_split_index(
    data_dir: str,
    split: str,
    seq_len: int,
    sliding_step: int,
    data_mode: str = "heatmap",
    padding: bool = False,
    debug: bool = False,
    use_cache: bool = True,
    input_hw: Optional[Tuple[int, int]] = None,
) -> SplitIndex:
    """Build (or load from its npz cache) the window index of a split:
    ``data_mode`` ``"heatmap"`` (TrackNet, from the label CSVs) or
    ``"coordinate"`` (InpaintNet, from ``predicted_csv``). The cache's name
    carries the mode."""
    build_fn = {"heatmap": build_rally_heatmap_index,
                "coordinate": build_rally_coordinate_index}.get(data_mode)
    if build_fn is None:
        raise ValueError(f"Invalid data_mode: {data_mode!r}")
    hgt, wdt = input_hw if input_hw is not None else (HEIGHT, WIDTH)
    rally_dirs = [os.path.join(data_dir, rd) for rd in get_rally_dirs(data_dir, split)]

    cfg_file = os.path.join(data_dir, f"img_config_{hgt}x{wdt}_{split}.npz")
    if use_cache and os.path.exists(cfg_file):
        with np.load(cfg_file) as cfg:
            img_shape, img_scaler = cfg["img_shape"], cfg["img_scaler"]
    else:
        img_shape, img_scaler = _rally_geometry(rally_dirs, (hgt, wdt))
        if use_cache:
            _atomic_savez(cfg_file, img_shape=img_shape, img_scaler=img_scaler)

    # padded indices get their own cache name (see the JAX package)
    pad_tag = "_pad" if padding else ""
    cache_file = os.path.join(
        data_dir, f"data_l{seq_len}_s{sliding_step}_{data_mode}{pad_tag}_{split}.npz"
    )
    if use_cache and os.path.exists(cache_file):
        with np.load(cache_file, allow_pickle=False) as loaded:
            data = {k: loaded[k] for k in loaded.files}
    else:
        parts = [
            build_fn(data_dir, rd, i, seq_len, sliding_step, padding)
            for i, rd in enumerate(rally_dirs)
        ]
        data = {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}
        if use_cache:
            _atomic_savez(cache_file, **data)

    if debug:
        data = {k: v[:256] for k, v in data.items()}
    return SplitIndex(data, rally_dirs, img_shape, img_scaler, (hgt, wdt))


class FrameCache:
    """Per-rally uint8 frames at model resolution (and diff frames).

    Each PNG is decoded once into the rally's npz cache (PIL bicubic
    resize, the reference recipe); later loads read the npz. Rallies are
    evicted least-recently-used beyond ``budget_bytes``.
    """

    _TAGS = {"": "rgb", "subtract": "diff", "subtract_concat": "diff", "concat": "concat"}

    def __init__(self, data_dir: str, bg_mode: str = "", budget_bytes: float = 12e9,
                 input_hw: Optional[Tuple[int, int]] = None):
        self.data_dir = data_dir
        self.bg_mode = bg_mode
        self.budget_bytes = budget_bytes
        self.input_hw = tuple(input_hw) if input_hw is not None else (HEIGHT, WIDTH)
        self._rallies: Dict[str, Dict[str, np.ndarray]] = {}  # insertion = recency

    def _cache_path(self, rally_dir: str) -> str:
        hgt, wdt = self.input_hw
        return os.path.join(rally_dir, f"cache_{hgt}x{wdt}_{self._TAGS[self.bg_mode]}.npz")

    def _build(self, rally_dir: str) -> Dict[str, np.ndarray]:
        from PIL import Image

        match_dir, rally_id = parse_rally_dir(rally_dir)
        n = len([f for f in os.listdir(rally_dir) if f.endswith("." + IMG_FORMAT)])
        need_diff = self.bg_mode in ("subtract", "subtract_concat")
        median = load_median_for_rally(match_dir, rally_id) if self.bg_mode else None
        hgt, wdt = self.input_hw
        rgb = np.zeros((n, hgt, wdt, 3), np.uint8)
        diff = np.zeros((n, hgt, wdt), np.uint8) if need_diff else None
        for i in range(n):
            with Image.open(os.path.join(rally_dir, f"{i}.{IMG_FORMAT}")) as im:
                im = im.convert("RGB")
                arr = np.asarray(im)
                rgb[i] = np.asarray(im.resize((wdt, hgt), Image.BICUBIC))
            if need_diff:
                d = np.sum(np.abs(arr - median), axis=2).astype("uint8")
                diff[i] = np.asarray(Image.fromarray(d).resize((wdt, hgt), Image.BICUBIC))
        out = {"rgb": rgb}
        if need_diff:
            out["diff"] = diff
        if self.bg_mode == "concat":
            med_img = Image.fromarray(median.astype("uint8"))
            out["median_resized"] = np.asarray(med_img.resize((wdt, hgt)))
        _atomic_savez(self._cache_path(rally_dir), **out)
        return out

    def load(self, rally_dir: str):
        """(rgb, diff or None, median_resized or None) of a rally."""
        data = self._rallies.pop(rally_dir, None)
        if data is None:
            path = self._cache_path(rally_dir)
            if os.path.exists(path):
                with np.load(path) as z:
                    data = {k: z[k] for k in z.files}
            else:
                data = self._build(rally_dir)
        self._rallies[rally_dir] = data  # most recent last
        while len(self._rallies) > 1 and self._used() > self.budget_bytes:
            self._rallies.pop(next(iter(self._rallies)))
        return data["rgb"], data.get("diff"), data.get("median_resized")

    def _used(self) -> int:
        return sum(a.nbytes for d in self._rallies.values() for a in d.values())


class HeatmapBatchLoader:
    """TrackNet batches as dicts of numpy arrays:

      id      (B, L, 2) int32      window identity (rally_i, frame pos)
      rgb     (B, L, H, W, 3) u8   resized frames      (rgb modes)
      diff    (B, L, H, W, 1) u8   resized diff frames (subtract modes)
      median  (B, H, W, 3) u8      resized median      (concat mode)
      cxcy    (B, L, 2) int32      input-space integer label centers
      coor    (B, L, 2) f32        label coordinates normalised by image size
      vis     (B, L) f32

    Channel stacking and label generation happen on the device.

    ``segment_windows`` > 1 groups each batch into segments of that many
    consecutive stride-1 windows, which share L-1 frames: the batch carries
    each segment's unique frames once (``seg_rgb`` / ``seg_diff``
    (n_seg, seg + L - 1, H, W, c), ``median`` (n_seg, H, W, 3)) and the
    train step expands them into the overlapping windows on the device.

    ``frame_alpha`` > 0 adds the frame-mixup blend plan of each window
    (``mix_pair`` (B, L, 2) int32, ``mix_pix_w`` (B, L) f32, ``mix_centers``
    (B, L, 2, 2) int32, ``mix_hm_w`` (B, L) f32; ``coor`` / ``vis`` follow the
    resampled slots). Segmented batches do not take frame mixup.

    With ``process_count`` > 1 each batch holds this process's contiguous
    slice of the global batch's rows (module docstring).
    """

    def __init__(
        self,
        index: SplitIndex,
        bg_mode: str = "",
        batch_size: int = 8,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 13,
        data_dir: str = "",
        frame_alpha: float = -1.0,
        segment_windows: int = 1,
        process_id: int = 0,
        process_count: int = 1,
    ):
        self.process_id, self.process_count = _process_slice(batch_size, drop_last,
                                                             process_id, process_count)
        self.index = index
        self.bg_mode = bg_mode
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.input_hw = tuple(index.input_hw)
        self.cache = FrameCache(data_dir, bg_mode, input_hw=self.input_hw)
        self.frame_alpha = frame_alpha
        self.segment_windows = max(int(segment_windows), 1)
        if self.segment_windows > 1:
            assert batch_size % self.segment_windows == 0, (
                f"batch_size {batch_size} not divisible by segment_windows "
                f"{self.segment_windows}"
            )
            assert frame_alpha <= 0, "segmented batches do not support frame mixup"
            self._segment_starts = _segment_starts(self.index.data["id"], self.segment_windows)

    def __len__(self):
        if self.segment_windows > 1:
            nsb = self.batch_size // self.segment_windows
            n = len(self._segment_starts)
            return n // nsb if self.drop_last else -(-n // nsb)
        n = len(self.index)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _gather_frames(self, ids: np.ndarray, frame_pos: np.ndarray):
        B, L = frame_pos.shape
        hgt, wdt = self.input_hw
        need_diff = self.bg_mode in ("subtract", "subtract_concat")
        need_rgb = self.bg_mode in ("", "subtract_concat", "concat")
        rgb = np.zeros((B, L, hgt, wdt, 3), np.uint8) if need_rgb else None
        diff = np.zeros((B, L, hgt, wdt, 1), np.uint8) if need_diff else None
        median = np.zeros((B, hgt, wdt, 3), np.uint8) if self.bg_mode == "concat" else None
        for b in range(B):
            r, d, m = self.cache.load(self.index.rally_dirs[ids[b, 0, 0]])
            pos = frame_pos[b]
            if need_rgb:
                rgb[b] = r[pos]
            if need_diff:
                diff[b] = d[pos][..., None]
            if median is not None:
                median[b] = m
        return rgb, diff, median

    def _iter_segmented(self, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Segmented batches: each segment's unique frames + window labels."""
        seg = self.segment_windows
        L = self.index.data["id"].shape[1]
        n_seg_batch = self.batch_size // seg
        starts = self._segment_starts.copy()
        if self.shuffle:
            self.rng.shuffle(starts)
        n_batches = len(starts) // n_seg_batch
        # drop_last=False: the remaining segments form a final short batch
        if not self.drop_last and len(starts) % n_seg_batch:
            n_batches += 1
        need_diff = self.bg_mode in ("subtract", "subtract_concat")
        need_rgb = self.bg_mode in ("", "subtract_concat", "concat")
        span = seg + L - 1  # unique frames per segment
        hgt, wdt = self.input_hw
        fid = self.index.data["frame_id"]
        if self.process_count > 1:
            assert n_seg_batch % self.process_count == 0, (
                "segments per batch must divide evenly across processes"
            )
        for bi in range(start_batch, n_batches):
            seg_starts = starts[bi * n_seg_batch : (bi + 1) * n_seg_batch]
            seg_starts = _rows_of(seg_starts, n_seg_batch, self.process_id, self.process_count)
            nsb = len(seg_starts)  # < n_seg_batch only for the tail batch
            # window rows of this batch, ordered segment-major
            sel = (seg_starts[:, None] + np.arange(seg)[None, :]).reshape(-1)
            ids, coor, vis, _, shape, cxcy = _window_labels(self.index, sel)
            rgb = np.zeros((nsb, span, hgt, wdt, 3), np.uint8) if need_rgb else None
            diff = np.zeros((nsb, span, hgt, wdt, 1), np.uint8) if need_diff else None
            median = np.zeros((nsb, hgt, wdt, 3), np.uint8) if self.bg_mode == "concat" else None
            for k, st in enumerate(seg_starts):
                first = self.index.data["id"][st]
                r, d, m = self.cache.load(self.index.rally_dirs[first[0, 0]])
                # the segment's unique frames by their on-disk ids (window
                # st's L rows + each later window's new last row): the label
                # CSV may skip frames
                fr = np.concatenate([fid[st], fid[st + 1 : st + seg, -1]])
                fr = np.clip(fr, 0, r.shape[0] - 1 if r is not None else d.shape[0] - 1)
                if need_rgb:
                    rgb[k] = r[fr]
                if need_diff:
                    diff[k] = d[fr][..., None]
                if median is not None:
                    median[k] = m
            batch = {"id": ids, "cxcy": cxcy, "coor": coor / shape[:, None, :], "vis": vis}
            if rgb is not None:
                batch["seg_rgb"] = rgb
            if diff is not None:
                batch["seg_diff"] = diff
            if median is not None:
                batch["median"] = median
            yield batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        yield from self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Batches from ``start_batch`` on, without assembling the skipped
        ones. With ``start_batch`` > 0 only a loader that does not shuffle
        gives the tail of one epoch."""
        assert start_batch == 0 or not self.shuffle, (
            "iter_from(start>0) on a shuffled loader would not match any "
            "single epoch's order"
        )
        if self.segment_windows > 1:
            yield from self._iter_segmented(start_batch)
            return
        n = len(self.index)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        B = self.batch_size
        stop = (n // B) * B if self.drop_last else n
        for s in range(start_batch * B, stop, B):
            sel = _rows_of(order[s : s + B], B, self.process_id, self.process_count)
            ids, coor, vis, scaler, shape, cxcy = _window_labels(self.index, sel)
            # pixels come from the on-disk frame numbers ({n}.png)
            frame_pos = self.index.data["frame_id"][sel]
            rgb, diff, median = self._gather_frames(ids, frame_pos)
            batch = {"id": ids, "cxcy": cxcy, "coor": coor / shape[:, None, :], "vis": vis}
            if rgb is not None:
                batch["rgb"] = rgb
            if diff is not None:
                batch["diff"] = diff
            if median is not None:
                batch["median"] = median
            if self.frame_alpha > 0:
                # one plan per window of this process's rows, drawn from the
                # loader's generator in batch order; len(sel), not B: the
                # final batch may be short
                plans = [
                    plan_frame_mixup(coor[b], vis[b], scaler[b, 0], scaler[b, 1],
                                     self.frame_alpha, self.rng)
                    for b in range(len(sel))
                ]
                batch["mix_pair"] = np.stack([p.frame_pair for p in plans])
                batch["mix_pix_w"] = np.stack([p.pix_w for p in plans])
                batch["mix_centers"] = np.stack([p.centers for p in plans])
                batch["mix_hm_w"] = np.stack([p.hm_w for p in plans])
                # the blend gathers frames mix_pair[b, l] of window b on the device
                check_starts(batch["mix_pair"], 1, frame_pos.shape[1])
                # viz-only coords/vis follow the resampled slots
                batch["coor"] = np.stack([p.coor for p in plans]) / shape[:, None, :]
                batch["vis"] = np.stack([p.vis for p in plans])
            yield batch


def resolve_frame_sharding(frame_sharding: str, total: float, budget_bytes: float,
                           holders: Optional[int]) -> str:
    """The JAX loader's placement of a split of ``total`` frame bytes:
    ``"single"`` on one device of one process (``holders`` None, whatever
    was asked); over ``holders`` (a mesh's entries, or the processes of a
    group) ``"auto"`` is ``"replicate"`` within ``budget_bytes`` and
    ``"shard"`` above it. Raises ``MemoryError`` where a holder's part
    exceeds the budget: a whole split unsharded, or 1/``holders`` of it."""
    mode = "single" if holders is None else frame_sharding
    if mode == "auto":
        mode = "replicate" if total <= budget_bytes else "shard"
    if mode == "shard" and total / holders > budget_bytes:
        raise MemoryError(f"split frames ({total / 1e9:.1f} GB) exceed the resident budget even "
                          f"sharded over {holders} devices")
    if mode != "shard" and total > budget_bytes:
        raise MemoryError(f"split frames ({total / 1e9:.1f} GB) exceed the resident "
                          f"budget ({budget_bytes / 1e9:.1f} GB)")
    return mode


def _rows_into(parts: List[np.ndarray], lo: int, hi: int, out: np.ndarray) -> None:
    """Rows ``[lo, hi)`` of the parts' concatenation into ``out``, the last
    row repeated past its end (the padding of a sharded buffer)."""
    at = 0
    for p in parts:
        a, b = max(lo, at), min(hi, at + len(p))
        if a < b:
            out[a - lo : b - lo] = p[a - at : b - at]
        at += len(p)
    if hi > at:
        out[max(at, lo) - lo :] = parts[-1][-1]


def _process_slice(batch_size: int, drop_last: bool, process_id: int,
                   process_count: int) -> Tuple[int, int]:
    """(process_id, process_count) after the JAX loaders' checks: several
    processes need full batches that they split evenly."""
    if process_count > 1:
        assert batch_size % process_count == 0, (
            f"batch_size {batch_size} not divisible by process_count {process_count}"
        )
        assert drop_last, "multi-host loaders require drop_last (full batches)"
    return int(process_id), int(process_count)


def _rows_of(rows: np.ndarray, per_batch: int, process_id: int,
             process_count: int) -> np.ndarray:
    """This process's contiguous 1/process_count slice of a batch's rows."""
    if process_count == 1:
        return rows
    loc = per_batch // process_count
    return rows[process_id * loc : (process_id + 1) * loc]


def _window_labels(index: SplitIndex, sel: np.ndarray):
    """(ids, coor, vis, scaler, shape, cxcy) of the index rows ``sel``."""
    ids = index.data["id"][sel]
    coor = index.data["coor"][sel].astype(np.float32)
    vis = index.data["vis"][sel].astype(np.float32)
    scaler = index.img_scaler[ids[:, 0, 0]]  # (B, 2)
    shape = index.img_shape[ids[:, 0, 0]]  # (B, 2)
    cx = (coor[..., 0] / scaler[:, None, 0]).astype(np.int32)
    cy = (coor[..., 1] / scaler[:, None, 1]).astype(np.int32)
    return ids, coor, vis, scaler, shape, np.stack([cx, cy], axis=-1)


def _segment_starts(ids: np.ndarray, seg: int) -> np.ndarray:
    """Index rows that start a segment of ``seg`` consecutive stride-1 windows
    of one rally: non-overlapping (stride ``seg`` within each run of valid
    starts) plus each run's final start, so a rally's tail windows are
    covered (a tail segment re-covers at most seg-1 windows)."""
    same_rally = ids[:, 0, 0]
    pos = ids[:, 0, 1]
    n = len(ids)
    ok = np.ones(n - seg + 1, bool) if n >= seg else np.zeros(0, bool)
    for k in range(1, seg):
        ok &= same_rally[k : n - seg + 1 + k] == same_rally[: n - seg + 1]
        ok &= pos[k : n - seg + 1 + k] == pos[: n - seg + 1] + k
    ok_idx = np.nonzero(ok)[0]
    runs = np.split(ok_idx, np.nonzero(np.diff(ok_idx) > 1)[0] + 1) if len(ok_idx) else []
    starts = []
    for r in runs:
        chosen = list(r[::seg])
        if chosen[-1] != r[-1]:
            chosen.append(r[-1])
        starts.extend(chosen)
    starts = np.asarray(starts, np.int64)
    if n > 0 and len(starts) == 0:
        raise ValueError(
            f"segment_windows={seg} found no consecutive stride-1 window runs - "
            "segmented batching requires an index built with sliding_step=1"
        )
    return starts


class ResidentHeatmapLoader:
    """TrackNet batches against split frames that live on the device.

    Every unique frame of the split goes to ``device`` once, as uint8, when
    the loader is built (through one pinned host buffer per device buffer);
    each batch then carries only flat frame indices and labels:

      res_idx         (B, L) int32   rows of ``res_rgb_buf`` / ``res_diff_buf``
      res_median_idx  (B,) int32     rows of ``res_median_buf`` (concat mode)
      res_rgb_buf     (T, H, W, 3) u8 device tensor   (rgb modes)
      res_diff_buf    (T, H, W, 1) u8 device tensor   (subtract modes)
      res_median_buf  (n_rally, H, W, 3) f32 device tensor (concat mode)
      id, cxcy, coor, vis            as ``HeatmapBatchLoader``

    and the train step gathers the windows on the device
    (``training/steps.assemble_tracknet_inputs``). Frame mixup needs the host
    blend planner: use ``HeatmapBatchLoader``. ``device`` has no default: the
    caller names the card, or asks for the CPU.

    Data parallel, as the JAX loader: the holders are the entries of a
    one-process ``mesh`` (``device`` is ignored) or the ``process_count`` > 1
    processes (each on its ``device``), and ``frame_sharding`` places the
    frames over them (``resolve_frame_sharding``; one device of one process
    is ``"single"``, and the split must fit ``budget_bytes``, else
    ``MemoryError``: callers fall back):

    - ``"replicate"``: every holder holds the split's buffers. On a mesh
      ``rgb_buf`` / ``diff_buf`` / ``median_buf`` and each batch's
      ``res_*_buf`` are tuples of the entries' buffers (an entry that repeats
      a device shares them), which ``parallel.mesh.shard_train_batch`` hands
      out; a process holds them whole on its ``device``.
    - ``"shard"``: the frame buffers, padded to a multiple of the N holders by
      repeating their last row, in N parts of R rows: holder j holds rows
      ``[j R, (j + 1) R)`` (a mesh's tuple of N shards; a process only its
      own). ``median_buf`` stays whole on every holder. Each batch also
      carries ``res_shards`` (``parallel.mesh.FrameShards``): the flat rows of
      the whole global batch's windows (every process reads the whole split
      and draws the same order), from which the step plans the exchange.
      The padding rows are never indexed.
    - ``"auto"``: ``"replicate"`` within the budget, else ``"shard"``.

    Under several processes each batch gives this process's contiguous rows.
    Each holder's rows go to its device through one pinned host buffer,
    copied once.
    """

    def __init__(
        self,
        index: SplitIndex,
        bg_mode: str = "",
        batch_size: int = 8,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 13,
        data_dir: str = "",
        budget_bytes: float = 6e9,
        mesh=None,
        frame_sharding: str = "auto",
        process_id: int = 0,
        process_count: int = 1,
        *,
        device,
    ):
        import torch

        if frame_sharding not in ("auto", "replicate", "shard"):
            raise ValueError(f"frame_sharding must be auto, replicate or shard, got "
                             f"{frame_sharding!r}")
        if mesh is not None and process_count > 1:
            raise ValueError("several processes hold one mesh entry each: pass no mesh")
        self.process_id, self.process_count = _process_slice(batch_size, drop_last, process_id,
                                                             process_count)
        self.index = index
        self.bg_mode = bg_mode
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.devices[0]
        holders = mesh.size if mesh is not None else (
            self.process_count if self.process_count > 1 else None)
        need_diff = bg_mode in ("subtract", "subtract_concat")
        need_rgb = bg_mode in ("", "subtract_concat", "concat")

        cache = FrameCache(data_dir, bg_mode, input_hw=index.input_hw)
        rgb_parts, diff_parts, medians, offsets = [], [], [], []
        total = 0
        off = 0
        for rd in index.rally_dirs:
            r, d, m = cache.load(rd)
            n = (r if r is not None else d).shape[0]
            offsets.append(off)
            off += n
            if need_rgb:
                rgb_parts.append(r)
                total += r.nbytes
            if need_diff:
                diff_parts.append(d[..., None])
                total += d.nbytes
            medians.append(m)
        self.frame_sharding = resolve_frame_sharding(frame_sharding, total, budget_bytes,
                                                     holders)
        self._offsets = np.asarray(offsets, np.int64)
        self._n_frames = off
        self._holders = holders
        # rows of the padded buffer each holder holds under "shard"
        self._shard_rows = -(-off // holders) if self.frame_sharding == "shard" else off
        shard = self.frame_sharding == "shard"
        self.rgb_buf = self._put(rgb_parts, shard) if need_rgb else None
        self.diff_buf = self._put(diff_parts, shard) if need_diff else None
        self.median_buf = (self._put([np.stack(medians).astype(np.float32)], False)
                           if bg_mode == "concat" else None)

    def _put(self, parts: List[np.ndarray], shard: bool):
        """The parts, concatenated along axis 0, on the holders: one tensor on
        ``device``, or on a mesh a tuple with one per entry. Whole (one per
        distinct device on a mesh), or under ``shard`` each holder's rows of
        the padded buffer (a mesh's N shards; a process its own). Each host
        buffer (pinned where a device is a card) is copied once."""
        import torch

        devices = [self.device] if self.mesh is None else list(self.mesh.devices)
        pin = any(d.type == "cuda" for d in devices)
        dtype = {"uint8": torch.uint8, "float32": torch.float32}[parts[0].dtype.name]
        n = sum(p.shape[0] for p in parts)

        def rows(lo: int, hi: int):
            host = torch.empty((hi - lo,) + parts[0].shape[1:], dtype=dtype, pin_memory=pin)
            _rows_into(parts, lo, hi, host.numpy())
            return host

        R = self._shard_rows
        if shard and self.mesh is not None:
            return tuple(rows(j * R, (j + 1) * R).to(d) for j, d in enumerate(devices))
        if shard:
            return rows(self.process_id * R, (self.process_id + 1) * R).to(self.device)
        host = rows(0, n)
        on: Dict = {}
        for d in devices:
            if d not in on:
                on[d] = host.to(d)
        return on[self.device] if self.mesh is None else tuple(on[d] for d in devices)

    def _flat_rows(self, sel: np.ndarray) -> np.ndarray:
        """(len(sel), L) int32 flat frame rows of the index rows ``sel``; the
        device gather does not clip, so a bad row is refused here."""
        rally_i = self.index.data["id"][sel][:, 0, 0]
        frame_pos = self.index.data["frame_id"][sel]  # (B, L) on-disk ids
        flat_idx = (self._offsets[rally_i][:, None] + frame_pos).astype(np.int32)
        check_starts(flat_idx, 1, self._n_frames)
        return flat_idx

    def __len__(self):
        n = len(self.index)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.index)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        B = self.batch_size
        stop = (n // B) * B if self.drop_last else n
        for s in range(0, stop, B):
            sel = _rows_of(order[s : s + B], B, self.process_id, self.process_count)
            ids, coor, vis, _, shape, cxcy = _window_labels(self.index, sel)
            rally_i = ids[:, 0, 0]
            flat_idx = self._flat_rows(sel)
            batch = {"id": ids, "res_idx": flat_idx, "cxcy": cxcy,
                     "coor": coor / shape[:, None, :], "vis": vis}
            if self.frame_sharding == "shard":
                every = self._flat_rows(order[s : s + B]) if self.process_count > 1 else flat_idx
                batch["res_shards"] = FrameShards(every, self._shard_rows, self._holders)
            if self.rgb_buf is not None:
                batch["res_rgb_buf"] = self.rgb_buf
            if self.diff_buf is not None:
                batch["res_diff_buf"] = self.diff_buf
            if self.median_buf is not None:
                batch["res_median_buf"] = self.median_buf
                batch["res_median_idx"] = rally_i.astype(np.int32)
            yield batch


class CoordinateBatchLoader:
    """InpaintNet batches (coordinate mode) as dicts of numpy arrays:

      id           (B, L, 2) int32   window identity (rally_i, frame pos)
      coor         (B, L, 2) f32     ground truth, normalised by (W, H)
      coor_pred    (B, L, 2) f32     TrackNet's prediction, normalised alike
      vis, pred_vis, inpaint_mask  (B, L, 1) f32

    (W, H) is the index's model input size. The shuffle, ``drop_last`` and
    the rows of each process (``process_count`` > 1) are the JAX loader's:
    the same ``np.random.default_rng(seed)`` stream gives the same batches."""

    def __init__(
        self,
        index: SplitIndex,
        batch_size: int = 8,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 13,
        process_id: int = 0,
        process_count: int = 1,
    ):
        self.process_id, self.process_count = _process_slice(batch_size, drop_last,
                                                             process_id, process_count)
        self.index = index
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.index)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        yield from self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """See ``HeatmapBatchLoader.iter_from``."""
        assert start_batch == 0 or not self.shuffle, (
            "iter_from(start>0) on a shuffled loader would not match any "
            "single epoch's order"
        )
        n = len(self.index)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        B = self.batch_size
        stop = (n // B) * B if self.drop_last else n
        norm = np.asarray([self.index.input_hw[1], self.index.input_hw[0]], np.float32)
        d = self.index.data
        for s in range(start_batch * B, stop, B):
            sel = _rows_of(order[s : s + B], B, self.process_id, self.process_count)
            yield {
                "id": d["id"][sel],
                "coor": d["coor"][sel].astype(np.float32) / norm,
                "coor_pred": d["coor_pred"][sel].astype(np.float32) / norm,
                "vis": d["vis"][sel].astype(np.float32)[..., None],
                "pred_vis": d["pred_vis"][sel].astype(np.float32)[..., None],
                "inpaint_mask": d["inpaint_mask"][sel].astype(np.float32)[..., None],
            }
