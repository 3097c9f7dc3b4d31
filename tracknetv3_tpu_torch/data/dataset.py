"""Shuttlecock Trajectory Dataset: window index, frame cache, batch loader.

Copy of the heatmap-mode parts of the JAX package's ``data/dataset.py``,
host-side numpy, with the same on-disk caches so a data directory prepared
by either package serves both:

- ``img_config_{H}x{W}_{split}.npz``: per-rally original (w, h) and scale;
- ``data_l{L}_s{S}_heatmap_{split}.npz``: the split's sliding-window index;
- ``{rally}/cache_{H}x{W}_{tag}.npz``: a rally's frames resized to the
  model resolution once, as uint8 (plus the resized median in concat
  mode).

``HeatmapBatchLoader`` shuffles with ``np.random.default_rng(seed)`` exactly
as the JAX loader does, so both yield the same batches. PIL and pandas are
imported only where a cache is missing. Frame mixup, segmented batches and
multi-process sharding are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import HEIGHT, IMG_FORMAT, WIDTH
from ..utils.io import (
    get_rally_dirs,
    label_csv_path,
    load_median_for_rally,
    parse_rally_dir,
    read_label_csv,
)


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
    df = read_label_csv(label_csv_path(match_dir, rally_id))
    frames = df["Frame"].to_numpy()
    x = df["X"].to_numpy(np.float32)
    y = df["Y"].to_numpy(np.float32)
    v = df["Visibility"].to_numpy(np.float32)

    padding = padding and sliding_step == seq_len
    windows = _slide_windows(len(df), seq_len, sliding_step, padding)
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
    from PIL import Image

    shapes, scalers = [], []
    for rd in rally_dirs:
        with Image.open(os.path.join(rd, f"0.{IMG_FORMAT}")) as im:
            w, h = im.size
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
    """Build (or load from its npz cache) the window index of a split."""
    if data_mode != "heatmap":
        raise NotImplementedError("the port's loader has heatmap mode only so far")
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
            build_rally_heatmap_index(data_dir, rd, i, seq_len, sliding_step, padding)
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
        if frame_alpha > 0:
            raise NotImplementedError("frame mixup (frame_alpha > 0) is not ported yet")
        if segment_windows > 1:
            raise NotImplementedError("segmented batches (segment_windows > 1) are not ported yet")
        if process_count > 1 or process_id != 0:
            raise NotImplementedError("multi-process loading is not ported yet")
        self.index = index
        self.bg_mode = bg_mode
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.input_hw = tuple(index.input_hw)
        self.cache = FrameCache(data_dir, bg_mode, input_hw=self.input_hw)

    def __len__(self):
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

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.index)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        B = self.batch_size
        stop = (n // B) * B if self.drop_last else n
        for s in range(0, stop, B):
            sel = order[s : s + B]
            ids = self.index.data["id"][sel]
            # pixels come from the on-disk frame numbers ({n}.png)
            frame_pos = self.index.data["frame_id"][sel]
            coor = self.index.data["coor"][sel].astype(np.float32)
            vis = self.index.data["vis"][sel].astype(np.float32)
            scaler = self.index.img_scaler[ids[:, 0, 0]]  # (B, 2)
            shape = self.index.img_shape[ids[:, 0, 0]]  # (B, 2)
            cx = (coor[..., 0] / scaler[:, None, 0]).astype(np.int32)
            cy = (coor[..., 1] / scaler[:, None, 1]).astype(np.int32)
            rgb, diff, median = self._gather_frames(ids, frame_pos)
            batch = {
                "id": ids,
                "cxcy": np.stack([cx, cy], axis=-1),
                "coor": coor / shape[:, None, :],
                "vis": vis,
            }
            if rgb is not None:
                batch["rgb"] = rgb
            if diff is not None:
                batch["diff"] = diff
            if median is not None:
                batch["median"] = median
            yield batch
