"""Global configuration of the PyTorch / CUDA TrackNetV3 port.

The constants and ``TrainConfig`` are a copy of the JAX package's
``tracknetv3_tpu/config.py`` (the port imports nothing from that package):
same names, same values and the same ``TrainConfig`` fields, so that a
checkpoint's ``param_dict`` round-trips between the two packages.

- ``HEIGHT``/``WIDTH``: model input resolution (reference 288x512).
- ``SIGMA``: radius of the binary-disk heatmap label.
- ``DELTA_T``/``COOR_TH``: normalized-coordinate threshold under which an
  InpaintNet output is treated as "no detection".
- ``IMG_FORMAT``: on-disk frame image format of the dataset layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

HEIGHT: int = 288
WIDTH: int = 512
SIGMA: float = 2.5
DELTA_T: float = 1.0 / math.sqrt(HEIGHT**2 + WIDTH**2)
COOR_TH: float = DELTA_T * 50
IMG_FORMAT: str = "png"

# Background modes supported by the data pipeline and the model factory.
BG_MODES = ("", "subtract", "subtract_concat", "concat")

# Evaluation prediction types: 5-way confusion.
PRED_TYPES = ("TP", "TN", "FP1", "FP2", "FN")
PRED_TYPES_MAP = {t: i for i, t in enumerate(PRED_TYPES)}
# InpaintNet's three confusions: refined vs ground truth, refined vs the
# TrackNet prediction, the prediction vs ground truth
INPAINTNET_EVAL_TYPES = ("inpaint", "reconstruct", "baseline")


def tracknet_in_channels(seq_len: int, bg_mode: str) -> int:
    """Input channel count of TrackNet for a given background mode.

      ''                -> seq_len * 3      (stacked RGB frames)
      'subtract'        -> seq_len          (1-channel difference frames)
      'subtract_concat' -> seq_len * 4      (RGB + difference channel)
      'concat'          -> (seq_len+1) * 3  (median image prepended)
    """
    if bg_mode == "subtract":
        return seq_len
    if bg_mode == "subtract_concat":
        return seq_len * 4
    if bg_mode == "concat":
        return (seq_len + 1) * 3
    if bg_mode == "":
        return seq_len * 3
    raise ValueError(f"Invalid bg_mode: {bg_mode!r}, must be one of {BG_MODES}")


@dataclasses.dataclass
class TrainConfig:
    """Training configuration; the same fields and defaults as the JAX
    package's ``TrainConfig`` so ``param_dict`` round-trips.

    Fields that select machinery not ported yet (``num_devices`` > 1,
    ``fast_bn``) are kept for the round trip; the port's training loop
    raises ``NotImplementedError`` when one is set.
    ``split_up_entry`` and ``sync_bn`` are formulation choices of the TPU
    step that do not change the function: the port ignores them.
    """

    model_name: str = "TrackNet"
    seq_len: int = 8
    epochs: int = 3
    batch_size: int = 10
    optim: str = "Adam"
    learning_rate: float = 1e-3
    lr_scheduler: str = ""
    bg_mode: str = ""
    alpha: float = -1.0
    frame_alpha: float = -1.0
    mask_ratio: float = 0.3
    tolerance: float = 4.0
    resume_training: bool = False
    seed: int = 13
    save_dir: str = "exp"
    debug: bool = False
    verbose: bool = False
    num_devices: Optional[int] = None
    compute_dtype: str = "bfloat16"
    sync_bn: bool = True
    segment_windows: int = 1
    resident_frames: bool = False
    fast_bn: bool = False
    split_up_entry: bool = True
    exact_decode: Any = False
    input_hw: Optional[tuple] = None

    def to_param_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_param_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in fields})
        if cfg.input_hw is not None:
            # JSON round-trips turn tuples into lists
            cfg.input_hw = tuple(int(v) for v in cfg.input_hw)
        return cfg
