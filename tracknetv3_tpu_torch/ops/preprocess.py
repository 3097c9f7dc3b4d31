"""Model-input assembly from frame windows (plain torch)."""

from __future__ import annotations

from typing import Optional

import torch


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
        colour-minor, with the median first in ``concat`` mode.
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
    return out.to(torch.float32) / 255.0
