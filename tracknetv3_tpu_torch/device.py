"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``"cpu"`` they raise instead of silently
running somewhere else.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU"
        )
    return dev
