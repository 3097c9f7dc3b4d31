"""Model-input assembly from frame windows (plain torch).

Copies of the JAX package's ``ops/preprocess.py`` functions that the
training and staged serving paths use, with the same results:
``window_channels``, ``gather_windows`` (indices clipped at the last
frame), ``background_diff`` (the reference's mod-256 wrap),
``median_of_u8_stack`` (exact ``np.median``) and
``make_staged_preprocessor`` (window gather, BGR flip, the four bg modes,
/255 in float32, then the output dtype).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

_INV_255 = float(np.float32(1.0 / 255.0))


def window_channels(
    frames: Optional[torch.Tensor],
    diffs: Optional[torch.Tensor],
    median_resized: Optional[torch.Tensor],
    bg_mode: str = "",
) -> torch.Tensor:
    """Stack per-frame channels into the model input, normalised /255.

    Same function as the JAX package's ``ops/preprocess.py::window_channels``.

    Args:
        frames: (..., L, h, w, 3) resized RGB frames in [0, 255].
        diffs: (..., L, h, w, 1) resized difference frames (subtract modes).
        median_resized: (h, w, 3) or per-sample (..., h, w, 3) median
            (concat mode).

    Returns:
        (..., h, w, C_in) float32 in [0, 1]; channels frame-major,
        colour-minor, with the median first in ``concat`` mode. /255 is a
        multiply by the float32 reciprocal, as XLA compiles the JAX
        function's ``/ 255.0``, so the two agree bit for bit.
    """

    def stack(x):  # (..., L, h, w, c) -> (..., h, w, L*c)
        x = x.movedim(-4, -2)
        return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))

    if bg_mode == "subtract":
        out = stack(diffs)
    elif bg_mode == "subtract_concat":
        out = stack(torch.cat([frames, diffs], dim=-1))
    elif bg_mode == "concat":
        med = median_resized
        if med.dim() != frames.dim() - 1:
            med = med.expand(frames.shape[:-4] + med.shape)
        out = torch.cat([med, stack(frames)], dim=-1)  # promotes like jnp
    elif bg_mode == "":
        out = stack(frames)
    else:
        raise ValueError(f"Invalid bg_mode: {bg_mode!r}")
    return out.to(torch.float32) * _INV_255


def gather_windows(per_frame: torch.Tensor, starts: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(T, h, w, c) per-frame data and (B,) window starts -> (B, L, h, w, c);
    frame indices are clipped into [0, T-1] (windows past the end repeat
    the last frame, the reference's padding rule)."""
    idx = starts[:, None] + torch.arange(seq_len, device=starts.device)[None, :]
    return per_frame[idx.clamp(0, per_frame.shape[0] - 1)]


def background_diff(frames: torch.Tensor, median: torch.Tensor) -> torch.Tensor:
    """``uint8(sum_c |frame - median|)`` as float32 (..., h, w, 1): the sum
    truncated and wrapped mod 256, as the reference's ``astype('uint8')``."""
    diff = (frames.to(torch.float32) - median.to(torch.float32)).abs().sum(dim=-1)
    return torch.remainder(torch.floor(diff), 256.0)[..., None]


def median_of_u8_stack(frames_u8: torch.Tensor) -> torch.Tensor:
    """Exact ``np.median`` over the leading axis of a uint8 stack: (T, ...)
    -> (...) float32. For even T it is the mean of the two middle values
    (``torch.median`` would return the lower one)."""
    T = frames_u8.shape[0]
    rows = frames_u8.reshape(T, -1).t().contiguous()  # one row per pixel

    def kth(k: int) -> torch.Tensor:  # k-th smallest, 1-based
        return torch.kthvalue(rows, k, dim=1).values.to(torch.float32)

    med = kth(T // 2 + 1) if T % 2 else (kth(T // 2) + kth(T // 2 + 1)) / 2.0
    return med.reshape(frames_u8.shape[1:])


def make_staged_preprocessor(
    bg_mode: str, seq_len: int, bgr: bool = False, out_dtype: Optional[torch.dtype] = None
) -> Callable[[torch.Tensor, Optional[torch.Tensor], torch.Tensor], torch.Tensor]:
    """Build ``run(buf_u8, median_resized, starts)`` -> model input for
    frames already at model resolution.

    ``buf_u8``: (T, h, w, 3) uint8 frames; ``median_resized``: (h, w, 3)
    float32 in the same channel order (or None where ``bg_mode`` needs
    none); ``starts``: (B,) window start frames. With ``bgr`` the buffer
    and median hold BGR and are flipped to RGB here. The background
    difference of the subtract modes is taken at model resolution. Returns
    (B, h, w, C_in) in [0, 1]: float32, cast to ``out_dtype`` if given.
    """
    needs_diff = bg_mode in ("subtract", "subtract_concat")
    needs_rgb = bg_mode in ("", "subtract_concat", "concat")

    def run(buf_u8, median_resized, starts):
        wins = gather_windows(buf_u8, starts, seq_len)  # (B, L, h, w, 3) uint8
        med = median_resized
        if bgr:
            wins = wins.flip(-1)
            med = med.flip(-1) if med is not None else None
        diffs = background_diff(wins, med) if needs_diff else None
        rgb = wins.to(torch.float32) if needs_rgb else None
        out = window_channels(rgb, diffs, med if bg_mode == "concat" else None, bg_mode)
        return out.to(out_dtype) if out_dtype is not None else out

    return run
