"""Small image-format helpers (API parity with reference utils/general.py).

Copy of the JAX package's ``utils/images.py``. Tensors are NHWC with
channel-stacked frames (N, H, W, L*C); the reference used channel-first
(N, L*C, H, W). These helpers turn model outputs into per-frame image
sequences for visualization and analysis.
"""

from __future__ import annotations

import numpy as np
import torch


def to_img(image: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> uint8 (reference: general.py:110-122)."""
    return (np.asarray(image) * 255).astype("uint8")


def to_img_format(x: np.ndarray, num_ch: int = 1) -> np.ndarray:
    """Model output (N, H, W, L*C) -> image sequence (N, L, H, W[, C]).

    num_ch=1 returns grayscale sequences (N, L, H, W); num_ch=3/4 returns
    (N, L, H, W, num_ch). Mirrors reference general.py:124-154 for the
    NHWC layout.
    """
    x = np.asarray(x)
    assert x.ndim == 4, "Input must be a 4D (N, H, W, L*C) tensor"
    n, h, w, lc = x.shape
    assert lc % num_ch == 0, f"channels {lc} not divisible by num_ch {num_ch}"
    L = lc // num_ch
    seq = x.reshape(n, h, w, L, num_ch)
    seq = np.moveaxis(seq, 3, 1)  # (N, L, H, W, C)
    if num_ch == 1:
        return seq[..., 0]
    return seq


def model_size_mb(model: torch.nn.Module) -> float:
    """Parameter + state footprint in MB (reference: general.py:82-96): the
    bytes of every tensor of the module's ``state_dict``."""
    total = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    return total / 1024**2
