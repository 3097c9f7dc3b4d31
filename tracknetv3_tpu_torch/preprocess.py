"""Dataset preparation CLI of the PyTorch port:
``python -m tracknetv3_tpu_torch.preprocess``.

The flags of the JAX package's ``preprocess.py`` (reference preprocess.py)
plus ``--device`` (default ``cuda``; ``cpu`` takes the medians on the
CPU), in the same steps:

1. installs the repo-shipped corrected test labels and ``drop_frame.json``
   if present (both layouts: ``match{N}/corrected_csv/`` and flat
   ``{match}_{rally}_ball.csv`` files);
2. extracts the frames of every train / test rally video (capped at the
   label count) as PNGs and takes each rally's median on the device;
3. takes the per-match medians;
4. carves a val split: the LAST rally of each training match is moved
   (a match's only rally stays);
5. writes the median previews.

``--regenerate_medians`` recomputes every rally and match median from the
videos instead. Frames are decoded and written with cv2 and the previews
with PIL, so this needs both; the rally medians run on the device over the
uint8 frames (``ops.preprocess.median_of_host_frames``), bit-equal to the
JAX package's host ``np.median`` over a float32 copy of the rally.
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--corrected_label_dir", type=str, default="corrected_test_label",
                   help="repo-shipped corrected test labels to install")
    p.add_argument("--regenerate_medians", action="store_true", default=False,
                   help="recompute every rally and match median from the videos "
                   "(reference: utils/general.py:527-537)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the rally medians are taken: cuda (default) or cpu")
    return p


def _label_count(csv_file: str) -> int:
    """Data rows of a label CSV (blank lines skipped, as pandas skips them)."""
    with open(csv_file, newline="", encoding="utf8") as f:
        return sum(1 for row in list(csv.reader(f))[1:] if row)


def install_corrected_labels(cl_dir: str, data_dir: str) -> None:
    """Copy ``drop_frame.json`` and the corrected test labels into the
    dataset: ``match{N}/corrected_csv/`` dirs (the reference layout) or
    flat ``{match_id}_{rally_id}_ball.csv`` files (reference install flow:
    preprocess.py:10-21)."""
    drop_src = os.path.join(cl_dir, "drop_frame.json")
    if os.path.exists(drop_src):
        shutil.copy(drop_src, os.path.join(data_dir, "drop_frame.json"))
    for name in sorted(os.listdir(cl_dir)):
        src = os.path.join(cl_dir, name)
        if os.path.isdir(src) and name.startswith("match"):
            src_csv = os.path.join(src, "corrected_csv")
            dst_dir = os.path.join(data_dir, "test", name, "corrected_csv")
            if os.path.isdir(src_csv) and not os.path.exists(dst_dir):
                shutil.copytree(src_csv, dst_dir)
        elif name.endswith(".csv"):
            match_id, rest = name.split("_", 1)
            dst_dir = os.path.join(data_dir, "test", f"match{match_id}", "corrected_csv")
            os.makedirs(dst_dir, exist_ok=True)
            shutil.copy(src, os.path.join(dst_dir, rest))


def generate_data_frames(video_file: str, device) -> None:
    """Write a rally's frames ``frame/{rally}/{n}.png`` (at most its label
    count; a rally with that many PNGs already is skipped) and its
    extraction-time median ``median.npz``: BGR frames, the median on
    ``device``, flipped to RGB (reference general.py:411-466)."""
    import cv2
    import numpy as np

    from .config import IMG_FORMAT
    from .ops.preprocess import median_of_host_frames
    from .utils.io import parse_video_file

    match_dir, rally_id = parse_video_file(video_file)
    csv_file = os.path.join(match_dir, "csv", f"{rally_id}_ball.csv")
    assert os.path.exists(csv_file), f"{csv_file} missing"
    n_labels = _label_count(csv_file)
    rally_dir = os.path.join(match_dir, "frame", rally_id)
    if os.path.isdir(rally_dir):
        done = [f for f in os.listdir(rally_dir) if f.endswith("." + IMG_FORMAT)]
        if len(done) >= n_labels:
            return  # already processed
        shutil.rmtree(rally_dir)
    os.makedirs(rally_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_file)
    frames = None  # (n_labels, h, w, 3) uint8, filled as the frames decode
    n = 0
    while n < n_labels:
        ok, frame = cap.read()
        if not ok:
            break
        if frames is None:
            frames = np.empty((n_labels,) + frame.shape, np.uint8)
        frames[n] = frame
        cv2.imwrite(os.path.join(rally_dir, f"{n}.{IMG_FORMAT}"), frame)
        n += 1
    cap.release()
    if not n:
        raise ValueError(f"no frames decodable from {video_file}")
    # The median over the label-count-capped extracted frames, as the
    # reference's extraction-time median (general.py:411-466). NOTE:
    # --regenerate_medians / io.get_rally_median take it over ALL frames of
    # the video instead (reference general.py:497-525): the reference
    # carries the same inconsistency between its two paths.
    median = median_of_host_frames(frames[:n], device)[..., ::-1]
    np.savez(os.path.join(rally_dir, "median.npz"), median=median)


def carve_val_split(data_dir: str, device) -> None:
    """Move the last rally of each training match (frames, video, CSV) to
    ``val`` and retake both matches' medians (a rally median that is
    missing is taken on ``device``); a match's only rally stays in train."""
    from .utils.io import get_match_median, list_dirs

    val_dir = os.path.join(data_dir, "val")
    for match_dir in list_dirs(os.path.join(data_dir, "train")):
        match_name = os.path.basename(match_dir)
        rallies = sorted(os.listdir(os.path.join(match_dir, "frame")))
        rallies = [r for r in rallies if os.path.isdir(os.path.join(match_dir, "frame", r))]
        if len(rallies) < 2:
            # moving a match's only rally would leave an empty train
            # match (no frames to median over); keep it in train
            if rallies:
                print(f"  {match_name}: single rally, not carved to val")
            continue
        last = rallies[-1]
        dst_match = os.path.join(val_dir, match_name)
        for sub, fname in [("frame", last), ("video", f"{last}.mp4"),
                           ("csv", f"{last}_ball.csv")]:
            src = os.path.join(match_dir, sub, fname)
            if os.path.exists(src):
                dst = os.path.join(dst_match, sub, fname)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.move(src, dst)
        get_match_median(dst_match, device)
        get_match_median(match_dir, device)


def _videos(match_dir: str):
    from .utils.io import list_dirs

    video_dir = os.path.join(match_dir, "video")
    if not os.path.isdir(video_dir):
        return None
    return [f for f in list_dirs(video_dir) if f.endswith(".mp4")]


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from .device import resolve_device
    from .utils.io import get_match_median, get_rally_median, list_dirs
    from .utils.visualize import plot_median_files

    dev = resolve_device(args.device)
    data_dir = args.data_dir

    if args.regenerate_medians:
        for split in ("train", "val", "test"):
            split_dir = os.path.join(data_dir, split)
            if not os.path.isdir(split_dir):
                continue
            for match_dir in list_dirs(split_dir):
                videos = _videos(match_dir)
                if videos is None:
                    continue
                for video_file in videos:
                    print(f"Processing {video_file}...")
                    get_rally_median(video_file, dev)
                get_match_median(match_dir, dev)
        print("Medians regenerated.")
        return

    # 1. Corrected test labels + drop_frame.json.
    if os.path.isdir(args.corrected_label_dir):
        install_corrected_labels(args.corrected_label_dir, data_dir)
        print("Installed corrected test labels.")

    # 2./3. Frame extraction, rally medians, match medians.
    for split in ("train", "test"):
        split_dir = os.path.join(data_dir, split)
        if not os.path.isdir(split_dir):
            continue
        for match_dir in list_dirs(split_dir):
            videos = _videos(match_dir)
            if videos is None:
                continue
            for video_file in videos:
                print(f"Processing {video_file}...")
                generate_data_frames(video_file, dev)
            get_match_median(match_dir, dev)

    # 4. Carve the val split.
    if not os.path.isdir(os.path.join(data_dir, "val")) and os.path.isdir(
            os.path.join(data_dir, "train")):
        carve_val_split(data_dir, dev)
        print("Carved val split.")

    # 5. Median previews.
    plot_median_files(data_dir)
    print("Done.")


if __name__ == "__main__":
    main()
