"""Binary-disk heatmap labels from integer centers (plain torch).

Squared distance from (cx, cy) on the 0-based pixel grid, thresholded at
``sigma**2``; an all-zero map where (cx, cy) == (0, 0) (no ball). Same
function as the JAX package's ``ops/heatmap.py::make_heatmaps``.
"""

from __future__ import annotations

import torch

from ..config import HEIGHT, SIGMA, WIDTH


def make_heatmaps(
    cx: torch.Tensor,
    cy: torch.Tensor,
    height: int = HEIGHT,
    width: int = WIDTH,
    sigma: float = SIGMA,
) -> torch.Tensor:
    """Integer centers of any shape ``S`` -> float32 maps ``S + (height, width)``."""
    cxf = cx.reshape(-1).float()
    cyf = cy.reshape(-1).float()
    rows = torch.arange(height, dtype=torch.float32, device=cx.device)[None, :, None]
    cols = torch.arange(width, dtype=torch.float32, device=cx.device)[None, None, :]
    d2 = (rows - cyf[:, None, None]) ** 2 + (cols - cxf[:, None, None]) ** 2
    disk = (d2 <= float(sigma) ** 2).float()
    visible = ((cxf != 0) | (cyf != 0)).float()
    return (disk * visible[:, None, None]).reshape(*cx.shape, height, width)
