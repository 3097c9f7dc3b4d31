"""Model-input assembly from frame windows (plain torch).

Copies of the JAX package's ``ops/preprocess.py`` functions that the
training and serving paths use, with the same results:
``window_channels``, ``gather_windows`` (indices clipped at the last
frame), ``background_diff`` (the reference's mod-256 wrap),
``median_of_u8_stack`` (exact ``np.median``; ``median_of_host_frames``
takes it over a host stack in slabs of image rows), ``yuv420_to_rgb``
(the BT.601 conversion of YUV420-staged frames, slab by slab),
``make_staged_preprocessor`` (window gather, BGR flip, the four bg modes,
/255 in float32, then the output dtype), and the device resize:
``_pil_bicubic_matrix`` (PIL's antialiased bicubic weights),
``resize_frames`` (two float32 matrix products, TF32 off) and
``make_window_preprocessor`` (raw frames resized once, then windowed).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import HEIGHT, WIDTH
from ..device import tf32_off

_INV_255 = float(np.float32(1.0 / 255.0))


@lru_cache(maxsize=32)
def _pil_bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) float32 resampling matrix of PIL's antialiased
    bicubic resize (Keys kernel a = -0.5, support scaled by the downscale
    factor, each row normalised): PIL's ``precompute_coeffs`` recipe, as
    the JAX package's copy builds it, bit for bit."""

    def keys(x, a=-0.5):
        x = np.abs(x)
        return np.where(
            x < 1,
            ((a + 2) * x - (a + 3)) * x * x + 1,
            np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0),
        )

    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    M = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        xs = np.arange(lo, hi)
        w = keys((xs + 0.5 - center) / fscale)
        M[i, lo:hi] = w / w.sum()
    M = M.astype(np.float32)
    M.flags.writeable = False  # the cache hands the same array to every caller
    return M


@lru_cache(maxsize=32)
def _resize_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """``_pil_bicubic_matrix`` on ``device``, copied there once (a copy from
    pageable memory on every chunk would stall the host)."""
    return torch.tensor(_pil_bicubic_matrix(n_in, n_out), device=device)


def resize_frames(frames: torch.Tensor, height: int = HEIGHT, width: int = WIDTH) -> torch.Tensor:
    """Resize (..., H0, W0, C) frames to (..., height, width, C) float32
    with PIL's antialiased bicubic, clipped to [0, 255], not normalised.

    Two float32 matrix products in the JAX function's order, first over
    the height, then over the width, with the channel axis moved ahead of
    (H0, W0). The JAX package asks for ``precision="highest"``; here TF32
    is off for both products (``tf32_off``): a TF32 resize is off by about
    a quarter of a grey level at 255.
    """
    h0, w0 = frames.shape[-3], frames.shape[-2]
    rh = _resize_matrix(h0, height, frames.device)  # (height, H0)
    rw = _resize_matrix(w0, width, frames.device)  # (width, W0)
    x = frames.movedim(-1, -3).to(torch.float32, memory_format=torch.contiguous_format)
    with tf32_off():
        x = torch.matmul(rh, x)  # (..., C, height, W0)
        x = torch.matmul(x, rw.t())  # (..., C, height, width)
    return x.clamp_(0.0, 255.0).movedim(-3, -1)


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


YUV_SLAB_FRAMES = 120  # frames converted at once by yuv420_to_rgb (the reader's slab)


def yuv420_to_rgb(flat: torch.Tensor, h: int, w: int, out: Optional[torch.Tensor] = None,
                  slab_frames: int = YUV_SLAB_FRAMES) -> torch.Tensor:
    """Planar YUV420 frames -> (T, h, w, 3) RGB uint8 (the JAX function).

    ``flat`` is (T, h*w*3//2) uint8, each row Y[h*w], U[h/2*w/2],
    V[h/2*w/2] as ``NativeVideoReader.read_into_yuv`` writes it. BT.601
    limited range in int32 with nearest 2x chroma upsampling:
    ``c = 298*(y-16)+128``, ``r = (c+409e)>>8``, ``g = (c-100d-208e)>>8``,
    ``b = (c+516d)>>8`` with ``d = u-128``, ``e = v-128`` (``>>`` is an
    arithmetic shift on int32, as XLA's), clipped to 0..255. Converted
    ``slab_frames`` frames at a time into ``out`` (allocated beside
    ``flat`` if not given), so the int32 temporaries stay the size of a
    slab whatever T is."""
    T = flat.shape[0]
    y_n, c_n = h * w, (h // 2) * (w // 2)
    if flat.dtype != torch.uint8 or flat.dim() != 2 or flat.shape[1] != y_n + 2 * c_n:
        raise ValueError(f"need (T, {y_n + 2 * c_n}) uint8 YUV420 rows for {h}x{w}, got "
                         f"{flat.dtype} {tuple(flat.shape)}")
    if out is None:
        out = torch.empty((T, h, w, 3), dtype=torch.uint8, device=flat.device)
    for lo in range(0, T, slab_frames):
        part = flat[lo:lo + slab_frames]
        n = part.shape[0]

        def chroma(a: int) -> torch.Tensor:  # nearest 2x upsample, minus 128
            c = part[:, a:a + c_n].reshape(n, h // 2, 1, w // 2, 1).to(torch.int32) - 128
            return c.expand(n, h // 2, 2, w // 2, 2).reshape(n, h, w)

        c = part[:, :y_n].reshape(n, h, w).to(torch.int32).sub_(16).mul_(298).add_(128)
        d, e = chroma(y_n), chroma(y_n + c_n)
        dst = out[lo:lo + n]
        dst[..., 0] = (c + 409 * e).bitwise_right_shift_(8).clamp_(0, 255)
        dst[..., 1] = (c - 100 * d - 208 * e).bitwise_right_shift_(8).clamp_(0, 255)
        dst[..., 2] = (c + 516 * d).bitwise_right_shift_(8).clamp_(0, 255)
    return out


MEDIAN_SLAB_BYTES = 1 << 28  # frame bytes on the device at once in median_of_host_frames


def median_of_host_frames(frames: np.ndarray, device: torch.device) -> np.ndarray:
    """``np.median`` over the leading axis of a host (k, h, w, C) uint8
    stack, taken with ``median_of_u8_stack`` on ``device`` one slab of
    image rows at a time: each pixel's median is its own, so the device
    holds at most ``MEDIAN_SLAB_BYTES`` of frames (and the working copies
    of one slab) whatever k is. Each slab is gathered into one reused host
    buffer, pinned for the card. Returns (h, w, C) float32 on the host."""
    k, h = frames.shape[:2]
    row = frames[0, 0].size  # elements of one image row of one frame
    rows = min(h, max(1, MEDIAN_SLAB_BYTES // max(1, k * row)))
    src = torch.from_numpy(frames)
    buf = torch.empty(k * rows * row, dtype=torch.uint8, pin_memory=device.type == "cuda")
    out = np.empty(frames.shape[1:], np.float32)
    for r in range(0, h, rows):
        n = min(rows, h - r)
        slab = buf[: k * n * row].view((k, n) + frames.shape[2:])
        slab.copy_(src[:, r:r + n])
        # .cpu() waits for the copy, so the next slab may overwrite the buffer
        out[r:r + n] = median_of_u8_stack(slab.to(device, non_blocking=True)).cpu().numpy()
    return out


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


def make_window_preprocessor(
    bg_mode: str, seq_len: int, hw: Optional[Tuple[int, int]] = None
) -> Callable[[torch.Tensor, Optional[torch.Tensor], torch.Tensor], torch.Tensor]:
    """Build ``run(frames_u8, median_orig, starts)`` -> model input for raw
    frames at source resolution (the device-resize path).

    ``frames_u8``: (T, H0, W0, 3) uint8 RGB frames covering the windows'
    span; ``median_orig``: (H0, W0, 3) float32 RGB median (or None where
    ``bg_mode`` needs none); ``starts``: (B,) window starts relative to
    ``frames_u8``'s first frame. ``hw`` is the model's (height, width).
    Every frame of the span is resized once and the windows are gathered
    from the resized frames. The subtract modes take the background
    difference at source resolution before the resize (the reference's
    order); ``concat`` resizes the median. Returns (B, height, width, C_in)
    float32 in [0, 1].
    """
    height, width = hw if hw is not None else (HEIGHT, WIDTH)
    needs_diff = bg_mode in ("subtract", "subtract_concat")
    needs_rgb = bg_mode in ("", "subtract_concat", "concat")

    def run(frames_u8, median_orig, starts):
        rgb = diffs = med_resized = None
        if needs_rgb:
            rgb = resize_frames(frames_u8, height, width)
        if needs_diff:
            diffs = resize_frames(background_diff(frames_u8, median_orig), height, width)
        if bg_mode == "concat":
            med_resized = resize_frames(median_orig, height, width)
        rgb_w = gather_windows(rgb, starts, seq_len) if rgb is not None else None
        diff_w = gather_windows(diffs, starts, seq_len) if diffs is not None else None
        return window_channels(rgb_w, diff_w, med_resized, bg_mode)

    return run
