"""COCO-format export and a self-contained single-class AP evaluator.

Host-only copy of the JAX package's ``evaluation/coco.py``: the ground truth
as COCO JSON with fixed 10x10 boxes (``convert_gt_to_coco_json``), the
prediction dicts as a COCO detection list (``get_coco_res``), and the
COCOeval 'bbox' AP of the single 'shuttlecock' category at one IoU threshold
(``evaluate_ap``: greedy score-ordered matching, 101-point interpolated
precision), written in numpy. An image's size comes from its PNG header
(``utils.io.png_size``), so neither PIL nor pandas is needed.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..config import IMG_FORMAT
from ..utils.io import get_rally_dirs, label_csv_path, parse_rally_dir, png_size, read_csv_columns


def _drop_frames(data_dir: str):
    with open(os.path.join(data_dir, "drop_frame.json")) as f:
        return json.load(f)


def gt_coco_json_path(data_dir: str, split: str, drop: bool = False) -> str:
    """The split's (and drop window's) ground-truth COCO JSON path."""
    suffix = "_drop" if (split == "test" and drop) else ""
    return os.path.join(data_dir, f"coco_format_gt_{split}{suffix}.json")


def convert_gt_to_coco_json(data_dir: str, split: str, drop: bool = False) -> str:
    """Write the split's ground-truth COCO JSON and return its path; with
    ``drop`` (test split) only the frames inside ``drop_frame.json``'s
    window of each rally."""
    drop_dict = _drop_frames(data_dir) if split == "test" and drop else None
    bbox_size = 10
    image_info, annotations = [], []
    sample_count = 0
    for rd in get_rally_dirs(data_dir, split):
        rally_dir = os.path.join(data_dir, rd)
        match_dir, rally_id = parse_rally_dir(rally_dir)
        match_id = match_dir.split("match")[-1]
        cols = read_csv_columns(label_csv_path(match_dir, rally_id),
                                ("Frame", "X", "Y", "Visibility"))
        f, x, y, v = (cols[k] for k in ("Frame", "X", "Y", "Visibility"))
        if drop_dict is not None:
            key = f"{match_id}_{rally_id}"
            s, e = drop_dict["start"][key], drop_dict["end"][key]
            f, x, y, v = f[s:e], x[s:e], y[s:e], v[s:e]
        w, h = png_size(os.path.join(rally_dir, f"0.{IMG_FORMAT}"))
        for fi, cx, cy, vis in zip(f, x, y, v):
            image_info.append({
                "id": sample_count,
                "width": w,
                "height": h,
                "file_name": f"{match_dir}/frame/{rally_id}/{int(fi)}.{IMG_FORMAT}",
            })
            if vis > 0:
                annotations.append({
                    "id": sample_count,
                    "image_id": sample_count,
                    "category_id": 1,
                    "bbox": [int(cx - bbox_size / 2), int(cy - bbox_size / 2), bbox_size,
                             bbox_size],
                    "ignore": 0,
                    "area": bbox_size * bbox_size,
                    "segmentation": [],
                    "iscrowd": 0,
                })
            sample_count += 1
    coco = {
        "info": {},
        "licenses": [],
        "categories": [{"id": 1, "name": "shuttlecock"}],
        "images": image_info,
        "annotations": annotations,
    }
    out = gt_coco_json_path(data_dir, split, drop)
    with open(out, "w") as fh:
        json.dump(coco, fh)
    return out


def get_coco_res(pred_dict: Dict, data_dir: str, drop: bool = False) -> List[Dict]:
    """Prediction dicts (with ``BBox`` and ``Confidence``) -> COCO detection
    list, one detection per visible frame."""
    drop_dict = _drop_frames(data_dir) if drop else None
    res_list = []
    sample_count = 0
    for rally_key, pred in pred_dict.items():
        pred = {k: list(v) for k, v in pred.items()}
        if drop_dict is not None:
            s, e = drop_dict["start"][rally_key], drop_dict["end"][rally_key]
            pred = {k: v[s:e] for k, v in pred.items()}
        for i in range(len(pred["Frame"])):
            if pred["Visibility"][i] > 0 and "BBox" in pred:
                res_list.append({
                    "id": sample_count,
                    "image_id": sample_count,
                    "category_id": 1,
                    "bbox": pred["BBox"][i],
                    "score": pred["Confidence"][i],
                    "ignore": 0,
                    "area": pred["BBox"][i][2] * pred["BBox"][i][3],
                    "segmentation": [],
                    "iscrowd": 0,
                })
            sample_count += 1
    return res_list


def _iou(box_a, box_b) -> float:
    ax, ay, aw, ah = box_a
    bx, by, bw, bh = box_b
    ix = max(0.0, min(ax + aw, bx + bw) - max(ax, bx))
    iy = max(0.0, min(ay + ah, by + bh) - max(ay, by))
    inter = ix * iy
    union = aw * ah + bw * bh - inter
    return inter / union if union > 0 else 0.0


def evaluate_ap(gt_json: str, detections: List[Dict], iou_threshold: float,
                max_dets: int = 100) -> float:
    """Single-class COCO AP at one IoU threshold (the JAX package's
    ``evaluate_ap``, the pycocotools protocol):

    - detections are stable-sorted by score within each image and cut to
      ``max_dets`` per image, the images concatenated in ascending id order,
      then stable-sorted by score again (score ties order by image id);
    - each detection takes the unmatched ground truth of best IoU, an equal
      IoU replacing the current best (the last ground truth wins a tie), and
      an IoU equal to the threshold matches;
    - AP is the mean over 101 recall thresholds of the monotone precision
      envelope, 0 where the recall is never reached.
    """
    with open(gt_json) as f:
        gt = json.load(f)
    gt_by_image: Dict[int, List] = {}
    for ann in gt["annotations"]:
        gt_by_image.setdefault(ann["image_id"], []).append(ann["bbox"])
    n_gt = sum(len(v) for v in gt_by_image.values())
    if n_gt == 0:
        return 0.0

    by_image: Dict[int, List] = {}
    for det in detections:
        by_image.setdefault(det["image_id"], []).append(det)
    ordered = []
    for img in sorted(by_image):
        ordered.extend(sorted(by_image[img], key=lambda d: -d["score"])[:max_dets])
    dets = sorted(ordered, key=lambda d: -d["score"])

    matched: Dict[int, set] = {}
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    thr = min(iou_threshold, 1 - 1e-10)
    for i, det in enumerate(dets):
        img = det["image_id"]
        best_iou, best_j = thr, -1
        for j, g in enumerate(gt_by_image.get(img, [])):
            if j in matched.get(img, set()):
                continue
            iou = _iou(det["bbox"], g)
            if iou < best_iou:
                continue
            best_iou, best_j = iou, j
        if best_j >= 0:
            tp[i] = 1
            matched.setdefault(img, set()).add(best_j)
        else:
            fp[i] = 1

    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / (ctp + cfp + np.spacing(1))
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        p = precision[recall >= r]
        ap += float(p.max()) if p.size else 0.0
    return ap / 101.0
