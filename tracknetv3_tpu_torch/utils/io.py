"""Dataset layout and label CSVs (host side).

Copy of the parts of the JAX package's ``utils/io.py`` that training reads.
Dataset layout (the reference's Shuttlecock Trajectory Dataset):

    {data_dir}/{split}/match{id}/csv/{rally}_ball.csv          (train/val)
    {data_dir}/{split}/match{id}/corrected_csv/{rally}_ball.csv (test)
    {data_dir}/{split}/match{id}/frame/{rally}/{n}.png
    {data_dir}/{split}/match{id}/frame/{rally}/median.npz
    {data_dir}/{split}/match{id}/median.npz

pandas is imported only where a label CSV is read, which happens only
when a split's index cache is missing.
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

import numpy as np


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


def label_csv_path(match_dir: str, rally_id: str) -> str:
    """Label CSV path; test matches use the corrected labels. The split is
    the parent component of ``.../{split}/match{N}``."""
    split = os.path.basename(os.path.dirname(os.path.normpath(match_dir)))
    if split == "test":
        return os.path.join(match_dir, "corrected_csv", f"{rally_id}_ball.csv")
    return os.path.join(match_dir, "csv", f"{rally_id}_ball.csv")


def read_label_csv(csv_file: str):
    """Label CSV as a pandas DataFrame sorted by Frame, blanks -> 0."""
    import pandas as pd

    return pd.read_csv(csv_file, encoding="utf8").sort_values(by="Frame").fillna(0)


def load_median_for_rally(match_dir: str, rally_id: str) -> np.ndarray:
    """Median background: the match's, else the rally's."""
    match_median = os.path.join(match_dir, "median.npz")
    rally_median = os.path.join(match_dir, "frame", rally_id, "median.npz")
    path = match_median if os.path.exists(match_median) else rally_median
    return np.load(path)["median"]
