"""Frame-level mixup: interleaved frame interpolation + resampling (host plan).

A copy of the JAX package's ``data/frame_mixup.py`` (numpy only). With
``frame_alpha > 0`` a training window of L frames becomes a 2L-1 sequence
[f0, blend(f0,f1), f1, blend(f1,f2), f2, ...] with lambda ~
Beta(frame_alpha, frame_alpha), from which L sorted indices are sampled. The
heatmap/coordinate interpolation rules per step i:

  - vis[i] == 0:            carry the previous heatmap for BOTH the blended
                            and the real slot; inter coords = previous.
  - prev_vis == 0 or the ball moved < 10 px (original space):
                            both slots take frame i's disk (no blend).
  - otherwise:              the blended slot's heatmap is
                            lambda*prev_disk + (1-lambda)*cur_disk.

This module computes only the *blend plan* on the host: for each selected
output slot, which two window frames to mix and with what pixel weight,
plus two disk centers and a heatmap blend weight. The pixel and heatmap
math runs on the device inside the train step
(``training/steps.assemble_tracknet_inputs`` / ``assemble_tracknet_labels``).
The order of the generator's draws (one ``beta``, then one ``choice``) is
part of the contract: both packages plan the same mixup from the same seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class MixupPlan:
    """Per-window blend plan, all arrays length L (the resampled slots).

    frame_pair: (L, 2) indices into the window's L source frames (ja, jb)
    pix_w:      (L,)   pixel weight: out = w*frame[ja] + (1-w)*frame[jb]
    centers:    (L, 2, 2) two (cx, cy) input-space disk centers
    hm_w:       (L,)   heatmap weight: map = w*disk(c0) + (1-w)*disk(c1)
    coor:       (L, 2) original-space coords of each slot (for viz)
    vis:        (L,)   visibility of each slot
    """

    frame_pair: np.ndarray
    pix_w: np.ndarray
    centers: np.ndarray
    hm_w: np.ndarray
    coor: np.ndarray
    vis: np.ndarray


def plan_frame_mixup(
    coor: np.ndarray,  # (L, 2) original-space label coords
    vis: np.ndarray,  # (L,)
    w_scaler: float,
    h_scaler: float,
    frame_alpha: float,
    rng: np.random.Generator,
) -> MixupPlan:
    L = len(vis)
    lam = float(rng.beta(frame_alpha, frame_alpha))

    def center(c) -> Tuple[int, int]:
        return int(c[0] / w_scaler), int(c[1] / h_scaler)

    # slot tuples: (ja, jb, pix_w, c_a, c_b, hm_w, coor, vis)
    c0 = center(coor[0])
    slots = [(0, 0, 1.0, c0, c0, 1.0, tuple(coor[0]), float(vis[0]))]
    prev_hm_center = c0
    prev_coor = coor[0]
    prev_vis = float(vis[0])
    for i in range(1, L):
        if vis[i] == 0:
            # carry previous heatmap for both slots
            slots.append(
                (i - 1, i, lam, prev_hm_center, prev_hm_center, 1.0,
                 tuple(prev_coor), prev_vis)
            )
            slots.append(
                (i, i, 1.0, prev_hm_center, prev_hm_center, 1.0,
                 tuple(coor[i]), float(vis[i]))
            )
            # prev heatmap center unchanged
        else:
            dist = math.sqrt(
                (prev_coor[0] - coor[i][0]) ** 2 + (prev_coor[1] - coor[i][1]) ** 2
            )
            ci = center(coor[i])
            if prev_vis == 0 or dist < 10:
                slots.append(
                    (i - 1, i, lam, ci, ci, 1.0, tuple(coor[i]), float(vis[i]))
                )
            else:
                slots.append(
                    (i - 1, i, lam, prev_hm_center, ci, lam,
                     tuple(coor[i]), float(vis[i]))
                )
            slots.append((i, i, 1.0, ci, ci, 1.0, tuple(coor[i]), float(vis[i])))
            prev_hm_center = ci
        prev_coor = coor[i]
        prev_vis = float(vis[i])

    sel = np.sort(rng.choice(len(slots), size=L, replace=False))
    picked = [slots[int(s)] for s in sel]
    return MixupPlan(
        frame_pair=np.asarray([(p[0], p[1]) for p in picked], np.int32),
        pix_w=np.asarray([p[2] for p in picked], np.float32),
        centers=np.asarray([(p[3], p[4]) for p in picked], np.int32),
        hm_w=np.asarray([p[5] for p in picked], np.float32),
        coor=np.asarray([p[6] for p in picked], np.float32),
        vis=np.asarray([p[7] for p in picked], np.float32),
    )
