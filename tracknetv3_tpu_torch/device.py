"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``"cpu"`` they raise instead of silently
running somewhere else.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

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


@contextlib.contextmanager
def tf32_off() -> Iterator[None]:
    """cuDNN convolutions and cuBLAS matrix products in full float32 (no
    TF32) inside the block; the other cuDNN flags keep their current values
    and the matrix-product flag gets its value back after the block."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = before
