"""TensorBoard logging and training visualizers.

Copy of the JAX package's ``utils/visualize.py`` (reference:
utils/visualize.py): per-epoch scalar logging of the losses and the 5-way
confusion metrics (all three eval variants for InpaintNet), a 4-panel
heatmap-prediction GIF, a trajectory dot plot, the FP1/FP2 error
histograms and the median previews. Scalars always go to
``scalars.jsonl`` next to the checkpoints, and to TensorBoard events where
``torch.utils.tensorboard`` imports. PIL and matplotlib are imported by the
function that draws with them, so the module imports without either.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np


class ScalarLogger:
    """``scalars.jsonl`` in ``log_dir`` (appended to, so a resumed run
    continues the file), plus TensorBoard events where TensorBoard is
    installed."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard: the JSONL file alone
            SummaryWriter = None
        self.tb = SummaryWriter(log_dir) if SummaryWriter is not None else None

    def add_scalar(self, tag: str, value: float, step: int):
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)
        self.jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")

    def flush(self):
        if self.tb is not None:
            self.tb.flush()
        self.jsonl.flush()

    def close(self):
        if self.tb is not None:
            self.tb.close()
        self.jsonl.close()


def write_to_tb(
    model_name: str,
    logger: ScalarLogger,
    losses: Tuple[float, float],
    val_res: Dict,
    epoch: int,
):
    """Per-epoch scalar dump (reference contract: utils/visualize.py:11-72)."""
    logger.add_scalar(f"{model_name}/loss/train", losses[0], epoch)
    logger.add_scalar(f"{model_name}/loss/val", losses[1], epoch)
    if model_name == "TrackNet":
        for k, v in val_res.items():
            logger.add_scalar(f"{model_name}/val/{k}", float(v), epoch)
    else:
        for eval_type, res in val_res.items():
            for k, v in res.items():
                logger.add_scalar(f"{model_name}/val_{eval_type}/{k}", float(v), epoch)
    logger.flush()


def plot_heatmap_pred_sample(
    frame: np.ndarray,
    y_true: np.ndarray,
    y_pred: np.ndarray,
    save_dir: str,
    name: str = "cur_pred",
):
    """4-panel (input | GT heatmap | raw pred | thresholded pred) GIF over
    the window (reference contract: utils/visualize.py:103-153)."""
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    L = y_true.shape[0]
    frames = []
    for f in range(L):
        img = (np.clip(frame[f], 0, 1) * 255).astype(np.uint8)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        gt = (np.clip(y_true[f], 0, 1) * 255).astype(np.uint8)
        pr = (np.clip(y_pred[f], 0, 1) * 255).astype(np.uint8)
        th = ((y_pred[f] > 0.5) * 255).astype(np.uint8)
        gray3 = lambda a: np.stack([a] * 3, axis=-1)  # noqa: E731
        panel = np.concatenate([img, gray3(gt), gray3(pr), gray3(th)], axis=1)
        frames.append(Image.fromarray(panel))
    frames[0].save(
        os.path.join(save_dir, f"{name}.gif"),
        save_all=True,
        append_images=frames[1:],
        duration=200,
        loop=0,
    )


def plot_traj_pred_sample(
    coor_gt: np.ndarray,
    coor_pred: np.ndarray,
    inpaint_mask: np.ndarray,
    save_dir: str,
    name: str = "cur_traj",
):
    """GT-vs-inpainted trajectory dot plot (reference: visualize.py:155-177)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.scatter(coor_gt[:, 0], coor_gt[:, 1], s=12, label="GT")
    masked = inpaint_mask[:, 0] > 0
    ax.scatter(
        coor_pred[masked, 0], coor_pred[masked, 1], s=12, marker="x", label="inpainted"
    )
    ax.invert_yaxis()
    ax.legend()
    fig.savefig(os.path.join(save_dir, f"{name}.png"), dpi=96)
    plt.close(fig)


def plot_diff_hist(
    pred_types_a,
    dists_a,
    pred_types_b,
    dists_b,
    labels=("baseline", "refined"),
    save_dir: str = ".",
    name: str = "error_hist",
):
    """FP1/FP2 pixel-error histograms comparing two evaluation results
    (reference contract: utils/visualize.py:179-290)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..config import PRED_TYPES_MAP

    os.makedirs(save_dir, exist_ok=True)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for ax, err_type in zip(axes, ("FP1", "FP2")):
        code = PRED_TYPES_MAP[err_type]
        for (types, dists), label in zip(
            ((pred_types_a, dists_a), (pred_types_b, dists_b)), labels
        ):
            types = np.asarray(types)
            dists = np.asarray(dists)
            sel = dists[types == code]
            ax.hist(sel, bins=20, alpha=0.5, label=f"{label} (n={len(sel)})")
        ax.set_title(f"{err_type} center-distance (px)")
        ax.legend()
    fig.tight_layout()
    out = os.path.join(save_dir, f"{name}.png")
    fig.savefig(out, dpi=96)
    plt.close(fig)
    return out


def plot_median_files(data_dir: str, save_dir: Optional[str] = None):
    """Dump median previews for every split/match (reference:
    utils/visualize.py:74-101)."""
    from PIL import Image

    save_dir = save_dir or os.path.join(data_dir, "median_preview")
    os.makedirs(save_dir, exist_ok=True)
    for split in ("train", "val", "test"):
        split_dir = os.path.join(data_dir, split)
        if not os.path.isdir(split_dir):
            continue
        for match in sorted(os.listdir(split_dir)):
            med_file = os.path.join(split_dir, match, "median.npz")
            if os.path.exists(med_file):
                med = np.load(med_file)["median"]
                Image.fromarray(med.astype(np.uint8)).save(
                    os.path.join(save_dir, f"{split}_{match}.png")
                )
