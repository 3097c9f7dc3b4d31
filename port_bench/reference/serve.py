"""The served rows of one clip, worked out plainly from its YUV420 frames
and the seeded weights (the published ``predict.py`` flow after decode).

1. YUV420 -> RGB: BT.601 limited range in integers, nearest 2x chroma
   (``c = 298 (y - 16) + 128``, ``r = (c + 409 e) >> 8``, ``g = (c - 100 d
   - 208 e) >> 8``, ``b = (c + 516 d) >> 8``, clipped to 0..255);
2. the background: the exact per-pixel median over every frame (the mean
   of the two middle values for an even count), as ``np.median``;
3. windows of L frames: every start 0 .. T-L (``weight``) or starts 0, L,
   2L, ... with frames past the end repeating the last one
   (``nonoverlap``); input channels ``[median, frame 0, ..., frame L-1]``
   (``concat``) or the frames alone, RGB, / 255;
4. TrackNet in float32 (TF32 off), a sigmoid;
5. the temporal ensemble (``weight``): frame t takes sum_j w[L-1-j] *
   p[t-j, j] with the triangular weights where all L windows cover it,
   else the plain mean of the windows that do; ``nonoverlap`` takes each
   frame from its window;
6. the decode of each frame's map: seed at the first maximum; the
   8-connected region of pixels above 0.5 around it inside the 64 x 64
   window centred on the seed (clipped into the frame); the centre of the
   region's bounding box ``x + w // 2``, ``y + h // 2``; (0, 0), invisible,
   where no pixel passes 0.5;
7. rows: ``int(cx * src_w / w)``, ``int(cy * src_h / h)``;
8. InpaintNet (``weight`` only): gaps of invisible frames flanked by
   detections below the top 5% of the frame are masked; windows of 16
   normalised points, the network's output composited into the masked
   frames, points with both coordinates under ``COOR_TH`` set to 0, the same
   ensemble, and ``int(float32(c) * W * (src_w / W))`` in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from scipy import ndimage

from .tracknet import Quant, inpaintnet, plain_math, tracknet_logits

CROP = 64
THRESHOLD = 0.5
COOR_TH = 50.0 / math.sqrt(288 ** 2 + 512 ** 2)
BLOCK = 16  # windows forwarded at once


def ensemble_weights(L: int) -> np.ndarray:
    w = np.asarray([min(i + 1, L - i) for i in range(L)], np.float64)
    return w / w.sum()


def yuv420_to_rgb(flat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    T, yn, cn = flat.shape[0], h * w, (h // 2) * (w // 2)
    y = flat[:, :yn].reshape(T, h, w).to(torch.int64)

    def up(a):
        c = flat[:, a:a + cn].reshape(T, h // 2, w // 2).to(torch.int64) - 128
        return c.repeat_interleave(2, 1).repeat_interleave(2, 2)

    c, d, e = 298 * (y - 16) + 128, up(yn), up(yn + cn)
    rgb = torch.stack([(c + 409 * e) >> 8, (c - 100 * d - 208 * e) >> 8, (c + 516 * d) >> 8], -1)
    return rgb.clamp(0, 255).to(torch.uint8)


def median(frames: torch.Tensor, slab: int = 1 << 15) -> torch.Tensor:
    """Exact per-pixel median of (T, ...) uint8 frames, float32."""
    T = frames.shape[0]
    flat = frames.reshape(T, -1)
    out = torch.empty(flat.shape[1], dtype=torch.float32, device=frames.device)
    for lo in range(0, flat.shape[1], slab):
        s = torch.sort(flat[:, lo:lo + slab], dim=0).values.to(torch.float32)
        out[lo:lo + slab] = s[T // 2] if T % 2 else 0.5 * (s[T // 2 - 1] + s[T // 2])
    return out.reshape(frames.shape[1:])


def window_starts(T: int, L: int, eval_mode: str) -> List[int]:
    return list(range(0, T, L)) if eval_mode == "nonoverlap" else list(range(max(T - L + 1, 1)))


def window_inputs(rgb: torch.Tensor, med: Optional[torch.Tensor], starts: torch.Tensor,
                  L: int) -> torch.Tensor:
    """(n, C_in, h, w) float32 inputs of the windows at ``starts``."""
    T, h, w = rgb.shape[:3]
    idx = (starts[:, None] + torch.arange(L, device=rgb.device)[None, :]).clamp(max=T - 1)
    x = rgb[idx].to(torch.float32) / 255.0  # (n, L, h, w, 3)
    x = x.permute(0, 1, 4, 2, 3).reshape(len(starts), 3 * L, h, w)
    if med is not None:
        x = torch.cat([(med / 255.0).permute(2, 0, 1).expand(len(starts), 3, h, w), x], 1)
    return x


def frame_probs(rgb: torch.Tensor, med: Optional[torch.Tensor], sd: Dict[str, torch.Tensor],
                L: int, eval_mode: str, quant: Quant = None,
                on_block: Optional[Callable] = None) -> torch.Tensor:
    """(T, h, w) float32 ensembled probabilities of every frame.
    ``on_block(starts, probs)`` sees each block's window starts and (n, L,
    h, w) probabilities."""
    T, h, w = rgb.shape[:3]
    dev = rgb.device
    starts = window_starts(T, L, eval_mode)
    S = len(starts)
    acc_w = torch.zeros((T, h, w), dtype=torch.float64, device=dev)
    acc_u = torch.zeros_like(acc_w)
    cnt = torch.zeros(T, dtype=torch.float64, device=dev)
    wts = ensemble_weights(L)
    for b0 in range(0, S, BLOCK):
        st = torch.as_tensor(starts[b0:b0 + BLOCK], device=dev)
        with torch.no_grad():
            p = torch.sigmoid(tracknet_logits(sd, window_inputs(rgb, med, st, L), quant=quant))
        if on_block is not None:
            on_block(st, p)
        p = p.to(torch.float64)
        for k in range(L):
            t = (st + k).clamp(max=T - 1)
            if eval_mode == "nonoverlap":
                keep = st + k < T
                acc_u[t[keep]] = p[keep, k]
                cnt[t[keep]] = 1.0
                continue
            acc_w.index_add_(0, t, p[:, k] * wts[L - 1 - k])
            acc_u.index_add_(0, t, p[:, k])
            cnt.index_add_(0, t, torch.ones_like(t, dtype=torch.float64))
    out = acc_u / cnt.clamp_min(1.0)[:, None, None]
    if eval_mode != "nonoverlap":
        steady = slice(L - 1, S)
        out[steady] = acc_w[steady]
    return out.to(torch.float32)


def decode(probs: torch.Tensor):
    """(T, h, w) maps -> (cx, cy) int64 arrays by the peak-blob rule."""
    T, h, w = probs.shape
    crop = min(CROP, h, w)
    flat = probs.reshape(T, -1)
    peak, idx = flat.max(dim=1)
    seed_r, seed_c = (idx // w).cpu().numpy(), (idx % w).cpu().numpy()
    r0 = np.clip(seed_r - crop // 2, 0, h - crop)
    c0 = np.clip(seed_c - crop // 2, 0, w - crop)
    dev = probs.device
    span = torch.arange(crop, device=dev)
    rows = torch.as_tensor(r0, device=dev)[:, None] + span
    cols = torch.as_tensor(c0, device=dev)[:, None] + span
    wins = probs[torch.arange(T, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    wins = (wins > THRESHOLD).cpu().numpy()
    has = (peak > THRESHOLD).cpu().numpy()
    cx = np.zeros(T, np.int64)
    cy = np.zeros(T, np.int64)
    eight = np.ones((3, 3), bool)
    for t in np.nonzero(has)[0]:
        lab, _ = ndimage.label(wins[t], structure=eight)
        ys, xs = np.nonzero(lab == lab[seed_r[t] - r0[t], seed_c[t] - c0[t]])
        x0, y0 = c0[t] + xs.min(), r0[t] + ys.min()
        cx[t] = x0 + (xs.max() - xs.min() + 1) // 2
        cy[t] = y0 + (ys.max() - ys.min() + 1) // 2
    return cx, cy


def inpaint_mask(vis: np.ndarray, y: np.ndarray, th_h: float) -> np.ndarray:
    """Gaps of invisible frames to inpaint: a leading gap when the frame
    after it lies below ``th_h``; an inner gap when both flanking
    detections do (a shuttle that left the top of the frame is not
    inpainted)."""
    n = len(vis)
    mask = np.zeros(n, np.int64)
    i = j = 0
    while j < n:
        while i < n - 1 and vis[i] == 1:
            i += 1
        j = i
        while j < n - 1 and vis[j] == 0:
            j += 1
        if j == i:
            break
        if i == 0 and y[j] > th_h:
            mask[:j] = 1
        elif i > 1 and y[i - 1] > th_h and y[j] > th_h:
            mask[i:j] = 1
        i = j
    return mask


def _below_th(c: torch.Tensor) -> torch.Tensor:
    th = (c[..., 0] < COOR_TH) & (c[..., 1] < COOR_TH)
    return torch.where(th[..., None], torch.zeros((), device=c.device), c)


def inpaint(rows: Dict[str, np.ndarray], sd: Dict[str, torch.Tensor], L: int,
            src_wh, hw, device, tf32: bool = False,
            on_net: Optional[Callable] = None) -> Dict[str, np.ndarray]:
    """InpaintNet over a trajectory (``weight`` windows of ``L``);
    ``on_net(coords, mask, out)`` sees the network's windows and output."""
    src_w, src_h = src_wh
    h, w = hw
    T = len(rows["X"])
    mask = inpaint_mask(rows["Visibility"], rows["Y"], src_h * 0.05).astype(np.float32)
    coords = np.stack([np.asarray(rows["X"], np.float32) / src_w,
                       np.asarray(rows["Y"], np.float32) / src_h], -1)
    S = max(T - L + 1, 1)
    idx = np.clip(np.arange(S)[:, None] + np.arange(L)[None, :], 0, T - 1)
    cw = torch.from_numpy(coords[idx]).to(device)
    mw = torch.from_numpy(mask[idx][..., None]).to(device)
    with plain_math(tf32), torch.no_grad():
        out = inpaintnet(sd, cw, mw)
    if on_net is not None:
        on_net(cw, mw, out)
    out = _below_th(out * mw + cw * (1.0 - mw)).to(torch.float64)
    wts = ensemble_weights(L)
    acc_w = torch.zeros((T, 2), dtype=torch.float64, device=device)
    acc_u = torch.zeros_like(acc_w)
    cnt = torch.zeros(T, dtype=torch.float64, device=device)
    tix = torch.from_numpy(idx).to(device)
    for k in range(L):
        acc_w.index_add_(0, tix[:, k], out[:, k] * wts[L - 1 - k])
        acc_u.index_add_(0, tix[:, k], out[:, k])
        cnt.index_add_(0, tix[:, k], torch.ones(S, dtype=torch.float64, device=device))
    ens = acc_u / cnt.clamp_min(1.0)[:, None]
    ens[L - 1:S] = acc_w[L - 1:S]
    flat = _below_th(ens.to(torch.float32)).cpu().numpy()
    cx = (flat[:, 0] * np.float32(w) * np.float32(src_w / w)).astype(np.int64)
    cy = (flat[:, 1] * np.float32(h) * np.float32(src_h / h)).astype(np.int64)
    return {"X": cx, "Y": cy, "Visibility": ((cx != 0) | (cy != 0)).astype(np.int64)}


def clip_rows(yuv: torch.Tensor, model: Dict, eval_mode: str, src_wh, sd: Dict[str, torch.Tensor],
              inpaint_sd: Optional[Dict[str, torch.Tensor]] = None, inpaint_len: int = 16,
              quant: Quant = None, inpaint_tf32: bool = False,
              on_block: Optional[Callable] = None, on_net: Optional[Callable] = None,
              on_frames: Optional[Callable] = None) -> Dict[str, np.ndarray]:
    """The served rows (X, Y, Visibility) of one clip's (T, h*w*3/2) YUV420
    frames on the reference's device; ``on_block`` as ``frame_probs``,
    ``on_net`` as ``inpaint``; ``on_frames(probs)`` sees the (T, h, w)
    ensembled frame maps."""
    h, w, L = int(model["height"]), int(model["width"]), int(model["seq_len"])
    rgb = yuv420_to_rgb(yuv, h, w)
    med = median(rgb) if model["bg_mode"] == "concat" else None
    with plain_math():
        probs = frame_probs(rgb, med, sd, L, eval_mode, quant, on_block)
    if on_frames is not None:
        on_frames(probs)
    cx, cy = decode(probs)
    src_w, src_h = src_wh
    X = (cx * (src_w / w)).astype(np.int64)
    Y = (cy * (src_h / h)).astype(np.int64)
    rows = {"X": X, "Y": Y, "Visibility": ((cx != 0) | (cy != 0)).astype(np.int64)}
    if inpaint_sd is not None:
        if eval_mode == "nonoverlap":
            raise ValueError("the reference inpaints weight-mode trajectories only")
        rows = inpaint(rows, inpaint_sd, inpaint_len, src_wh, (h, w), yuv.device, inpaint_tf32,
                       on_net)
    return rows


def rows_off(served: Dict[str, np.ndarray], ref: Dict[str, np.ndarray], tol_px: float) -> int:
    """Frames whose visibility differs, or whose X or Y differs by more than
    ``tol_px`` source pixels; every frame where the lengths differ."""
    if len(served["X"]) != len(ref["X"]):
        return max(len(served["X"]), len(ref["X"]))
    dx = np.abs(np.asarray(served["X"]) - np.asarray(ref["X"]))
    dy = np.abs(np.asarray(served["Y"]) - np.asarray(ref["Y"]))
    bad = (np.asarray(served["Visibility"]) != np.asarray(ref["Visibility"]))
    bad |= np.maximum(dx, dy) > tol_px
    return int(np.count_nonzero(bad))
