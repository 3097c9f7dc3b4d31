"""Temporal ensemble over overlapping inference windows (plain torch).

Same functions as the JAX package's ``ops/ensemble.py``. With a sliding
step of 1, frame ``t`` is covered by up to ``L`` windows, and its
prediction is the anti-diagonal sum

    out[t] = sum_j weight[L-1-j] * buf[t - j, j]

taken as L slices of the buffer of window outputs. Warm-up frames (the
first L-1) and tail frames (the last L-1, from ``ensemble_flush``) take the
unweighted mean of the windows that cover them (reference test.py:637-692).

The carried state holds the last L-1 window outputs on the device and the
index of the next frame to finalise as a host integer: the serving loop
knows every chunk's real window count (``n_valid``) on the host, so no
value is read back from the card between chunks. Padded windows (rows at
or past ``n_valid``) are replaced with zeros by ``where``, not multiplied
away, so non-finite padding cannot leak into real frames.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch


def get_ensemble_weight(seq_len: int, eval_mode: str) -> np.ndarray:
    """'average' -> uniform 1/L; 'weight' -> triangular [1, 2, .., 2, 1]
    normalised to sum 1 (reference test.py:25-50)."""
    if eval_mode == "average":
        return np.full(seq_len, 1.0 / seq_len, dtype=np.float32)
    if eval_mode == "weight":
        w = np.ones(seq_len, dtype=np.float32)
        for i in range(math.ceil(seq_len / 2)):
            w[i] = i + 1
            w[seq_len - i - 1] = i + 1
        return w / w.sum()
    raise ValueError(f"Invalid eval_mode: {eval_mode!r}")


class EnsembleState(NamedTuple):
    """The last L-1 window outputs (zeros before the first window and for
    padded windows) and the index of the next frame to finalise (== the
    number of real windows consumed)."""

    tail: torch.Tensor  # (L-1, L, *frame_shape) float32
    next_frame: int


def ensemble_init(seq_len: int, frame_shape: Tuple[int, ...],
                  device: Union[str, torch.device] = "cpu") -> EnsembleState:
    shape = (seq_len - 1, seq_len) + tuple(frame_shape)
    return EnsembleState(torch.zeros(shape, dtype=torch.float32, device=device), 0)


def _bshape(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, 1, ...) for broadcasting over frame dims."""
    return v.reshape(v.shape + (1,) * (ndim - 1))


def _anti_diagonals(wp: torch.Tensor, w_rev: torch.Tensor, B: int, L: int):
    """Unweighted and weighted sums of ``wp[L-1-j : L-1-j+B, j]`` over j.

    Each weighted term is added as one fused multiply-add, rounded once to
    float32: XLA contracts the JAX function's ``out_w + contrib * w`` into
    an FMA, and a constant trajectory ensembled without it lands one ulp
    off, which flips the integer truncation of InpaintNet's coordinates.
    The FMA is computed in float64, where a float32 product is exact."""
    out_u = out_w = None
    for j in range(L):
        contrib = wp[L - 1 - j : L - 1 - j + B, j]
        out_u = contrib if out_u is None else out_u + contrib
        if out_w is None:
            out_w = contrib * w_rev[j]
        else:
            fma = out_w.double() + contrib.double() * w_rev[j].double()
            out_w = fma.to(torch.float32)
    return out_u, out_w


def ensemble_update_fn(
    state: EnsembleState, window_preds: torch.Tensor, weights: torch.Tensor, n_valid: int
) -> Tuple[EnsembleState, torch.Tensor]:
    """Consume B consecutive windows, emit one frame per window.

    Only the first ``n_valid`` windows are real; padded windows neither
    contribute nor advance the frame counter, and the frames emitted for
    them are garbage the caller drops.

    Args:
        state: the carried tail.
        window_preds: (B, L, *frame_shape); row b is global window
            ``state.next_frame + b``.
        weights: (L,) ensemble weights summing to 1.
        n_valid: number of real windows in this call.

    Returns:
        (new state, frames (B, *frame_shape)): finalised frames
        next_frame .. next_frame + B - 1.
    """
    n_valid = int(n_valid)
    B, L = window_preds.shape[0], window_preds.shape[1]
    dev = window_preds.device
    wp = window_preds.to(torch.float32)
    valid = torch.arange(B, device=dev) < n_valid
    wp = torch.where(_bshape(valid, wp.ndim), wp, torch.zeros((), device=dev))
    buf = torch.cat([state.tail, wp], dim=0)  # (L-1+B, L, *fs)

    out_u, out_w = _anti_diagonals(buf, weights.to(dev, torch.float32).flip(0), B, L)
    t = state.next_frame + torch.arange(B, device=dev)
    cnt = torch.clamp(t + 1, max=L).to(torch.float32)
    warm = t < (L - 1)
    frames = torch.where(_bshape(warm, out_u.ndim), out_u / _bshape(cnt, out_u.ndim), out_w)
    # the L-1 window outputs before the next unfinalised frame
    new_tail = buf[n_valid : n_valid + L - 1]
    return EnsembleState(new_tail, state.next_frame + n_valid), frames


def ensemble_flush(state: EnsembleState) -> torch.Tensor:
    """Tail frames S .. S+L-2 after the last window S-1: (L-1, *frame_shape)
    unweighted means over the windows that covered each of them. Rows past
    the video's real frame count are garbage the caller trims."""
    L = state.tail.shape[1]
    S = state.next_frame
    # tail[i] holds window S-L+1+i; tail frame S+k takes tail[i, k+L-1-i]
    outs = []
    for k in range(L - 1):
        acc = None
        for i in range(k, L - 1):
            c = state.tail[i, k + L - 1 - i]
            acc = c if acc is None else acc + c
        cnt = float(min(L - 1 - k, S))
        outs.append(acc / max(cnt, 1.0))
    return torch.stack(outs, dim=0)


def ensemble_chunk(
    window_preds: torch.Tensor, weights: torch.Tensor, t0: int, num_windows: int
) -> torch.Tensor:
    """Stateless ensemble: finalise B frames from B+L-1 windows.

    Args:
        window_preds: (B+L-1, L, *fs); row k is global window
            ``t0 - L + 1 + k`` (rows of windows outside [0, num_windows)
            are arbitrary and masked here).
        weights: (L,) ensemble weights.
        t0: global index of the first frame finalised.
        num_windows: S, the number of real windows.

    Returns:
        (B, *fs) frames t0 .. t0+B-1 (rows past frame S+L-2 are garbage).
    """
    t0, num_windows = int(t0), int(num_windows)
    nwin, L = window_preds.shape[0], window_preds.shape[1]
    B = nwin - (L - 1)
    dev = window_preds.device
    wp = window_preds.to(torch.float32)
    w_global = t0 - (L - 1) + torch.arange(nwin, device=dev)
    valid = (w_global >= 0) & (w_global < num_windows)
    wp = torch.where(_bshape(valid, wp.ndim), wp, torch.zeros((), device=dev))

    out_u, out_w = _anti_diagonals(wp, weights.to(dev, torch.float32).flip(0), B, L)
    t = t0 + torch.arange(B, device=dev)
    # windows covering frame t: [max(0, t-L+1), min(t, S-1)]
    cnt = torch.clamp(t, max=num_windows - 1) - torch.clamp(t - L + 1, min=0) + 1
    cnt = torch.clamp(cnt, min=1).to(torch.float32)
    steady = (t >= L - 1) & (t < num_windows)
    return torch.where(_bshape(steady, out_u.ndim), out_w, out_u / _bshape(cnt, out_u.ndim))
