"""The benchmark's synthetic inputs: a rally scene, its YUV420 frames and a
training split on disk.

Frozen copies of what ``chip_smoke.py`` draws (``_Scene``, ``bt601_yuv420``,
``write_synthetic_dataset``, ``_write_png``), kept here so that the
yardstick does not move when that script changes. The scene is a seeded
textured background and a bright disk (radius 4 at the model's 288x512) on a
parabolic arc, one 40-frame pass after another; as in the training rallies
that ``write_synthetic_dataset`` draws, the disk is hidden on frames 12-15
of each pass, so a trajectory has gaps for InpaintNet to fill. The frames
repeat with the pass, so a pass is drawn once and a clip is a slice of a
pool of passes.
"""

from __future__ import annotations

import csv
import json
import math
import os
import shutil
import struct
import zlib
from typing import Tuple

import numpy as np
import torch

PERIOD = 40
HIDDEN = (12, 16)  # frames [12, 16) of each pass hide the disk
BASE_RGB = (40, 90, 40)
TEXTURE = 40  # background = BASE_RGB + uniform integers in [0, TEXTURE)
RADIUS = 4.0  # of the disk, in pixels of the frames as drawn (model resolution)


def center(t: int, w: int, h: int) -> Tuple[float, float]:
    """The disk's (x, y) on frame ``t`` of a (w, h) scene, in pixels: not
    rounded, so the disk's pixels and the heatmap's edge differ from frame
    to frame, as a moving shuttle's do."""
    u = (t % PERIOD) / (PERIOD - 1)
    return w * 0.1 + w * 0.8 * u, h * 0.7 - h * 0.5 * math.sin(math.pi * u)


def visible(t: int) -> bool:
    return not HIDDEN[0] <= t % PERIOD < HIDDEN[1]


def labels(T: int, w: int, h: int) -> np.ndarray:
    """(T, 4) int64 label rows (frame, visibility, x, y); x = y = 0 where
    the disk is hidden."""
    rows = []
    for t in range(T):
        x, y = center(t, w, h)
        v = visible(t)
        rows.append((t, int(v), int(x) if v else 0, int(y) if v else 0))
    return np.asarray(rows, np.int64)


def background(gen: torch.Generator, h: int, w: int, device) -> torch.Tensor:
    """(h, w, 3) uint8 textured background drawn from ``gen``."""
    tex = torch.randint(0, TEXTURE, (h, w, 3), generator=gen, device=device, dtype=torch.int32)
    return (tex + torch.tensor(BASE_RGB, device=device, dtype=torch.int32)).to(torch.uint8)


def draw_pass(bg: torch.Tensor, radius: float = RADIUS) -> torch.Tensor:
    """The (PERIOD, h, w, 3) uint8 frames of one pass over ``bg``, on its
    device."""
    h, w = bg.shape[:2]
    r = radius
    dev = bg.device
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    frames = bg.unsqueeze(0).repeat(PERIOD, 1, 1, 1)
    for t in range(PERIOD):
        if not visible(t):
            continue
        x, y = center(t, w, h)
        frames[t][(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = 255
    return frames


def bt601_yuv420(rgb: torch.Tensor) -> torch.Tensor:
    """(T, h, w, 3) RGB uint8 -> (T, h*w*3//2) planar YUV420 rows (Y, U,
    V): the BT.601 limited-range forward transform in float64, chroma
    averaged over 2x2 blocks, rounded: what a decoder's 4:2:0 output
    holds."""
    f = rgb.to(torch.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    u = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    v = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    T, h, w = y.shape

    def pooled(c):
        return c.reshape(T, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    planes = [torch.round(p).clamp_(0, 255).to(torch.uint8).reshape(T, -1)
              for p in (y, pooled(u), pooled(v))]
    return torch.cat(planes, dim=1)


def yuv_pool(seed: int, frames: int, h: int, w: int, device) -> np.ndarray:
    """(frames, h*w*3//2) uint8 host pool of the scene's YUV420 frames,
    drawn and converted on ``device``, background drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    one = bt601_yuv420(draw_pass(background(gen, h, w, device))).cpu().numpy()
    reps = -(-frames // PERIOD)
    return np.ascontiguousarray(np.tile(one, (reps, 1))[:frames])


# ------------------------------------------------------------ the training split


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb`` (h, w, 3), written with zlib and struct."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))  # filter 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def rally_frames(data_seed: int, rally: int, T: int, h: int, w: int) -> np.ndarray:
    """(T, h, w, 3) uint8 frames of training rally ``rally``: its own
    background from numpy's generator, so the same on every host."""
    rng = np.random.default_rng([data_seed, rally])
    bg = (np.asarray(BASE_RGB, np.int32) + rng.integers(0, TEXTURE, (h, w, 3))).astype(np.uint8)
    one = draw_pass(torch.from_numpy(bg)).numpy()
    return np.ascontiguousarray(np.tile(one, (-(-T // PERIOD), 1, 1, 1))[:T])


def rally_dirs(rallies: int, per_match: int = 4):
    """(match, rally id) of each training rally, in the loader's order."""
    return [(1 + i // per_match, f"1_{1 + i % per_match:02d}_00") for i in range(rallies)]


def write_split(root: str, data_seed: int, rallies: int, T: int, h: int, w: int) -> None:
    """The train split in the dataset layout the loaders read: per rally a
    label CSV, ``frame/{rally}/0.png`` (its size) and the npz frame cache
    ``cache_{h}x{w}_concat.npz`` (frames and their median), so no PNG is
    decoded. Written into ``root + ".tmp"`` and renamed, with
    ``complete.json`` last."""
    tmp = root + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    lab = labels(T, w, h)
    for i, (m, rally) in enumerate(rally_dirs(rallies)):
        match_dir = os.path.join(tmp, "train", f"match{m}")
        frame_dir = os.path.join(match_dir, "frame", rally)
        os.makedirs(frame_dir, exist_ok=True)
        os.makedirs(os.path.join(match_dir, "csv"), exist_ok=True)
        with open(os.path.join(match_dir, "csv", f"{rally}_ball.csv"), "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["Frame", "Visibility", "X", "Y"])
            wr.writerows(lab.tolist())
        frames = rally_frames(data_seed, i, T, h, w)
        median = np.median(frames, axis=0).astype(np.uint8)
        with open(os.path.join(frame_dir, f"cache_{h}x{w}_concat.npz"), "wb") as f:
            np.savez(f, rgb=frames, median_resized=median)
        write_png(os.path.join(frame_dir, "0.png"), frames[0])
    with open(os.path.join(tmp, "complete.json"), "w") as f:
        json.dump({"data_seed": data_seed, "rallies": rallies, "frames": T, "hw": [h, w]}, f)
    shutil.rmtree(root, ignore_errors=True)
    os.replace(tmp, root)


def ensure_split(root: str, data_seed: int, rallies: int, T: int, h: int, w: int) -> bool:
    """Write the split at ``root`` unless a complete one with these
    parameters is there; True where it was written."""
    want = {"data_seed": data_seed, "rallies": rallies, "frames": T, "hw": [h, w]}
    try:
        with open(os.path.join(root, "complete.json")) as f:
            if json.load(f) == want:
                return False
    except (FileNotFoundError, json.JSONDecodeError):
        pass
    write_split(root, data_seed, rallies, T, h, w)
    return True
