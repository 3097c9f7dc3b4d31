"""Dataset layout, label and prediction CSVs, video reading and writing.

Copy of the JAX package's ``utils/io.py`` (pandas left out): training,
serving (one video, streaming, batches, the overlay video), rally
evaluation, dataset preparation (the rally and match medians) and the web
UIs' label CSVs.
Dataset layout (the reference's Shuttlecock Trajectory Dataset):

    {data_dir}/{split}/match{id}/csv/{rally}_ball.csv          (train/val)
    {data_dir}/{split}/match{id}/corrected_csv/{rally}_ball.csv (test)
    {data_dir}/{split}/match{id}/predicted_csv/{rally}_ball.csv (InpaintNet)
    {data_dir}/{split}/match{id}/frame/{rally}/{n}.png
    {data_dir}/{split}/match{id}/frame/{rally}/median.npz
    {data_dir}/{split}/match{id}/median.npz

The rally median is taken on the card (``ops.preprocess.median_of_host_frames``
on the uint8 frames, bit-equal to the JAX package's host ``np.median``); the
match median, over a few rally medians, on the host. Label and prediction CSVs are read and written with the ``csv`` module
(no pandas), in pandas' ``to_csv(index=False)`` format; a frame's size is
read from its PNG header (no PIL). ``cv2`` is imported only where a video
file is opened.
"""

from __future__ import annotations

import csv
import os
import re
import struct
from collections import deque
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .profiling import span


def list_dirs(directory: str) -> List[str]:
    return sorted(os.path.join(directory, p) for p in os.listdir(directory))


def parse_rally_dir(rally_dir: str) -> Tuple[str, str]:
    """'{...}/match{N}/frame/{rally}' -> (match_dir, rally_id)."""
    rally_dir = rally_dir.rstrip("/")
    m = re.match(r"^(.*)[/\\]frame[/\\]([^/\\]+)$", rally_dir)
    if not m:
        raise ValueError(f"Not a rally directory: {rally_dir!r}")
    return m.group(1), m.group(2)


def get_rally_dirs(data_dir: str, split: str) -> List[str]:
    """All rally frame dirs of a split, relative to ``data_dir``: matches
    sorted numerically, rallies lexically."""
    split_dir = os.path.join(data_dir, split)
    match_dirs = [os.path.join(split, d) for d in os.listdir(split_dir)]
    match_dirs = sorted(match_dirs, key=lambda s: int(s.split("match")[-1]))
    rally_dirs = []
    for match_dir in match_dirs:
        frame_root = os.path.join(data_dir, match_dir, "frame")
        for rally in sorted(os.listdir(frame_root)):
            if os.path.isdir(os.path.join(frame_root, rally)):
                rally_dirs.append(os.path.join(match_dir, "frame", rally))
    return rally_dirs


def parse_video_file(video_file: str) -> Tuple[str, str]:
    """'{...}/video/{rally}.mp4' -> (match_dir, rally_id)."""
    m = re.match(r"^(.*)[/\\]video[/\\]([^/\\]+)\.mp4$", video_file)
    if not m:
        raise ValueError(f"Not a dataset video path: {video_file!r}")
    return m.group(1), m.group(2)


def label_csv_path(match_dir: str, rally_id: str) -> str:
    """Label CSV path; test matches use the corrected labels. The split is
    the parent component of ``.../{split}/match{N}``."""
    split = os.path.basename(os.path.dirname(os.path.normpath(match_dir)))
    if split == "test":
        return os.path.join(match_dir, "corrected_csv", f"{rally_id}_ball.csv")
    return os.path.join(match_dir, "csv", f"{rally_id}_ball.csv")


def read_csv_columns(csv_file: str, columns) -> Dict[str, np.ndarray]:
    """The named columns of a label or prediction CSV as float64 arrays,
    rows sorted by ``Frame`` and blank fields read as 0 (the JAX package's
    pandas reader's rules), read with the ``csv`` module: the card's
    machine has no pandas."""
    with open(csv_file, newline="", encoding="utf8") as f:
        rows = list(csv.reader(f))
    header, rows = rows[0], [r for r in rows[1:] if r]
    cols = {name: np.array([float(r[i]) if r[i].strip() else 0.0 for r in rows], np.float64)
            for i, name in enumerate(header) if name in ("Frame", *columns)}
    missing = [c for c in ("Frame", *columns) if c not in cols]
    if missing:
        raise KeyError(f"{csv_file} has no column {missing}")
    order = np.argsort(cols["Frame"], kind="stable")
    return {name: cols[name][order] for name in columns}


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) of a PNG image from its IHDR chunk, as PIL's
    ``Image.open(path).size`` reads them."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG image")
    width, height = struct.unpack(">II", head[16:24])
    return width, height


def load_median_for_rally(match_dir: str, rally_id: str) -> np.ndarray:
    """Median background: the match's, else the rally's."""
    match_median = os.path.join(match_dir, "median.npz")
    rally_median = os.path.join(match_dir, "frame", rally_id, "median.npz")
    path = match_median if os.path.exists(match_median) else rally_median
    return np.load(path)["median"]


def read_label_rows(csv_file: str) -> Dict[str, list]:
    """Pandas-free label CSV reader: column dict, rows sorted by Frame,
    blank/NaN cells -> 0 and numeric cells parsed to float (the semantics
    of the JAX package's pandas ``read_label_csv``: ``fillna(0)``); non-numeric cells are preserved
    VERBATIM so a write-back never destroys extra annotation columns.

    The web UI serves requests from a secondary HTTP-server thread where
    pandas' arrow-backed string index construction segfaults on some hosts;
    every CSV touch on that path must stay off pandas."""

    def val(s):
        if s is None or s == "":
            return 0.0  # blank cell: pandas fillna(0) equivalent
        try:
            f = float(s)
            return f if f == f else 0.0  # NaN -> 0
        except ValueError:
            return s  # non-numeric cell: keep as-is

    def sort_key(row):
        v = val(row.get("Frame"))
        return v if isinstance(v, float) else 0.0

    with open(csv_file, newline="", encoding="utf8") as f:
        reader = csv.DictReader(f)
        cols = list(reader.fieldnames or [])
        rows = sorted(reader, key=sort_key)
    return {c: [val(row.get(c)) for row in rows] for c in cols}


def write_label_rows(rows: Dict[str, list], save_file: str) -> None:
    """Pandas-free CSV writer for read_label_rows dicts; integral floats are
    written as ints to match the reference CSV style, strings verbatim."""

    def fmt(v):
        if isinstance(v, str):
            return v
        return int(v) if float(v).is_integer() else v

    cols = list(rows)
    n = len(rows[cols[0]]) if cols else 0
    with open(save_file, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for i in range(n):
            w.writerow([fmt(rows[c][i]) for c in cols])


def write_pred_csv(pred_dict: Dict, save_file: str, save_inpaint_mask: bool = False) -> None:
    """Write the prediction CSV (reference contract: general.py:322-354),
    byte for byte what the JAX package's pandas writer produces."""
    cols = ["Frame", "Visibility", "X", "Y"]
    if save_inpaint_mask:
        cols = ["Frame", "Visibility_GT", "X_GT", "Y_GT", "Visibility", "X", "Y",
                "Inpaint_Mask"]
    with span("serve::csv"), open(save_file, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        w.writerows(zip(*(pred_dict[c] for c in cols)))


def _require_cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading a video file needs OpenCV (cv2), which is not installed; "
            "decode the frames elsewhere and pass them to "
            "TrackNetPredictor.stage_frames"
        ) from e
    return cv2


class VideoReader:
    """Thin cv2.VideoCapture wrapper yielding RGB uint8 frames."""

    def __init__(self, video_file: str):
        cv2 = _require_cv2()
        if not os.path.exists(video_file):
            raise FileNotFoundError(video_file)
        self.path = video_file
        self.cap = cv2.VideoCapture(video_file)
        self.video_len = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS))
        self.w = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.h = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def read(self) -> Optional[np.ndarray]:
        ok, frame = self.cap.read()
        if not ok:
            return None
        return frame[..., ::-1]  # BGR -> RGB

    def seek(self, frame_idx: int) -> None:
        self.cap.set(_require_cv2().CAP_PROP_POS_FRAMES, frame_idx)

    def read_all(self) -> np.ndarray:
        """Every frame from the start: (T, h, w, 3) RGB uint8."""
        self.seek(0)
        frames = []
        while True:
            f = self.read()
            if f is None:
                break
            frames.append(f)
        return np.stack(frames) if frames else np.zeros((0, self.h, self.w, 3), np.uint8)

    def sample_frames(
        self,
        max_sample_num: int = 1800,
        video_range: Optional[Tuple[int, int]] = None,
    ) -> np.ndarray:
        """The frames the median background is taken over: at most about
        ``max_sample_num`` at a uniform stride (reference
        dataset.py:748-781), over ``video_range`` (start, end) seconds;
        frames that do not decode are skipped. (k, h, w, 3) RGB uint8."""
        if video_range is None:
            start, end = 0, self.video_len
        else:
            start = max(0, int(video_range[0] * self.fps))
            end = min(int(video_range[1] * self.fps), self.video_len)
        seg = end - start
        step = seg // max_sample_num if seg > max_sample_num else 1
        frames = []
        for i in range(start, end, max(step, 1)):
            self.seek(i)
            f = self.read()
            if f is None:
                # one bad frame mid-video should not bias the median toward
                # the clip's start: skip it and keep sampling
                continue
            frames.append(f)
        if not frames:
            raise ValueError(
                f"no frames decodable for the median background "
                f"(video_len={self.video_len}, range={video_range}) - "
                f"corrupt video or a range outside the clip?"
            )
        return np.stack(frames)

    def sample_median(
        self,
        max_sample_num: int = 1800,
        video_range: Optional[Tuple[int, int]] = None,
    ) -> np.ndarray:
        """Median background of ``sample_frames`` on the host, as the JAX
        package's reader takes it: (h, w, 3) float32 RGB."""
        return np.median(self.sample_frames(max_sample_num, video_range).astype(np.float32),
                         axis=0)

    def read_resized_bgr(self, width: int, height: int) -> np.ndarray:
        """Decode every frame from the start, resized to (height, width) with
        ``cv2.INTER_LINEAR`` and kept in BGR: the JAX package's cv2 staging
        decode (``inference.upload_video_slabs``). (T, height, width, 3)."""
        cv2 = _require_cv2()
        self.cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        frame = np.empty((self.h, self.w, 3), np.uint8)
        out: List[np.ndarray] = []
        while self.cap.grab():
            ok, f = self.cap.retrieve(frame)
            if not ok:
                break
            out.append(cv2.resize(f, (width, height), interpolation=cv2.INTER_LINEAR))
        return np.stack(out) if out else np.zeros((0, height, width, 3), np.uint8)

    def release(self) -> None:
        self.cap.release()


def generate_frames(video_file: str) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Decode a whole video to an RGB uint8 array (T, H, W, 3)."""
    r = VideoReader(video_file)
    frames = r.read_all()
    fps, wh = r.fps, (r.w, r.h)
    r.release()
    return frames, fps, wh


def draw_traj_comet(
    frame_bgr: np.ndarray, traj: Sequence[Optional[Tuple[int, int]]], color=(0, 255, 255)
) -> np.ndarray:
    """Draw the trailing-comet trajectory dots (reference general.py:227-250)."""
    cv2 = _require_cv2()
    for p in traj:
        if p is not None:
            cv2.circle(frame_bgr, (int(p[0]), int(p[1])), 3, (255, 255, 255), -1)
            cv2.circle(frame_bgr, (int(p[0]), int(p[1])), 3, color, 1)
    return frame_bgr


def write_pred_video(
    video_file: str,
    pred_dict: Dict,
    save_file: str,
    traj_len: int = 8,
    label: Optional[Mapping[str, Sequence]] = None,
) -> None:
    """Overlay the predicted (and, given ``label``, the labelled)
    trajectory on the video as an mp4v file (reference contract:
    general.py:252-320). ``label`` holds the label CSV's ``Visibility``,
    ``X`` and ``Y`` columns (the JAX package takes a pandas frame; the
    card's machine has no pandas). Needs cv2."""
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(video_file)
    fps = cap.get(cv2.CAP_PROP_FPS)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    out = cv2.VideoWriter(save_file, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))

    x_pred, y_pred, vis_pred = pred_dict["X"], pred_dict["Y"], pred_dict["Visibility"]
    pred_q: deque = deque()
    gt_q: deque = deque()
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok or i >= len(x_pred):
            break
        if len(pred_q) >= traj_len:
            pred_q.pop()
        if label is not None and len(gt_q) >= traj_len:
            gt_q.pop()
        if label is not None:
            if i < len(label["Visibility"]) and label["Visibility"][i]:
                gt_q.appendleft((label["X"][i], label["Y"][i]))
            else:
                gt_q.appendleft(None)
        pred_q.appendleft((x_pred[i], y_pred[i]) if vis_pred[i] else None)
        if label is not None:
            frame = draw_traj_comet(frame, gt_q, color=(0, 0, 255))
        frame = draw_traj_comet(frame, pred_q, color=(0, 255, 255))
        out.write(frame)
        i += 1
    out.release()
    cap.release()


# ------------------------------- medians ---------------------------------


def get_rally_median(video_file: str, device=None) -> np.ndarray:
    """Compute and save ``frame/{rally}/median.npz``: the median of every
    frame of the video (reference general.py:497-525), taken on ``device``
    (``None``: the card) over the uint8 frames: no float32 stack of the
    rally is made on the host."""
    from ..device import resolve_device
    from ..ops.preprocess import median_of_host_frames

    dev = resolve_device(device)
    match_dir, rally_id = parse_video_file(video_file)
    save_dir = os.path.join(match_dir, "frame", rally_id)
    frames, _, _ = generate_frames(video_file)
    if not len(frames):
        raise ValueError(f"no frames decodable from {video_file}")
    median = median_of_host_frames(frames, dev)
    os.makedirs(save_dir, exist_ok=True)
    np.savez(os.path.join(save_dir, "median.npz"), median=median)
    return median


def get_match_median(match_dir: str, device=None) -> np.ndarray:
    """Median of the rally medians, saved as ``{match}/median.npz``
    (reference general.py:468-495); a rally without its median gets one
    from its video first (on ``device``). The few rally medians are
    reduced on the host."""
    medians = []
    for rally_dir in list_dirs(os.path.join(match_dir, "frame")):
        if not os.path.isdir(rally_dir):
            continue
        _, rally_id = parse_rally_dir(rally_dir)
        med_file = os.path.join(rally_dir, "median.npz")
        if not os.path.exists(med_file):
            get_rally_median(os.path.join(match_dir, "video", f"{rally_id}.mp4"), device)
        medians.append(np.load(med_file)["median"])
    if not medians:
        raise ValueError(
            f"{match_dir} has no rally frame dirs - cannot compute a match "
            "median (was its only rally moved to the val split?)"
        )
    median = np.median(np.stack(medians), axis=0)
    np.savez(os.path.join(match_dir, "median.npz"), median=median)
    return median
