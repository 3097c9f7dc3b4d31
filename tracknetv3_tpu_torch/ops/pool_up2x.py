"""2x2 max pool and nearest-2x upsample of the serving forward (hand-written
CUDA kernels).

The JAX serving forward pools with ``_pool`` (a 2x2 stride-2
``reduce_window`` max) and upsamples with ``_up2x`` (nearest 2x by
broadcast and reshape), three times each; ``tools/probe_bn_pool.py``'s
Pallas kernels ``pool_pl`` and ``up2x_pl`` were written for those two
functions. Here they are the kernels of ``csrc/pool_up2x.cu``.

Tensors are NCHW views with channels_last memory (physically NHWC), as the
port's convolutions produce them, in bfloat16 (serving) or float32 (the
parity path). On a CPU tensor each wrapper returns its plain version
(``maxpool2x2_plain``, ``up2x_nearest_plain``: one PyTorch call each); on
a CUDA tensor it launches the kernel or raises. Each launch counts under
``launch.<kernel>`` (``utils/profiling``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import cuda_build

SOURCE = "pool_up2x.cu"
KERNELS = ("maxpool2x2", "up2x_nearest")  # launch counters
profiling.declare(*(f"launch.{k}" for k in KERNELS))

_P = ctypes.c_void_p
_I = ctypes.c_int
# the kernels' C entry points per dtype: bfloat16 on the serving path,
# float32 for parity runs
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernels' C entry points."""
    lib = cuda_build.load(SOURCE)
    for kind in ("maxpool2x2", "up2x_nearest"):
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"{kind}_nhwc_{suffix}")
            fn.argtypes = [_P, _P, _I, _I, _I, _I, _P]
            fn.restype = _I
    return lib


def maxpool2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of NCHW ``x`` (NaN propagates)."""
    return F.max_pool2d(x, 2)


def up2x_nearest_plain(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of NCHW ``x``: each pixel becomes a 2x2 block."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def check_kernel_input(x: torch.Tensor, even_hw: bool) -> None:
    """Raise unless ``x`` is what the kernels take: a 4-D bfloat16 or
    float32 NCHW view in channels_last memory, a pixel's channels a
    multiple of 16 bytes, a 16-byte aligned base and, for the pool, even H
    and W."""
    if x.dim() != 4 or x.dtype not in _SUFFIX:
        raise ValueError(f"need a 4-D bfloat16 or float32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    N, C, H, W = x.shape
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("need channels_last (NHWC) memory")
    if (C * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(f"need 16-byte channel rows and a 16-byte aligned tensor, "
                         f"got C={C} of {x.dtype}")
    if even_hw and (H % 2 or W % 2):
        raise ValueError(f"the 2x2 pool needs even H and W, got {H}x{W}")


def _launch(x: torch.Tensor, y: torch.Tensor, what: str) -> None:
    fn = getattr(_lib(), f"{what}_nhwc_{_SUFFIX[x.dtype]}")
    N, C, H, W = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), N, H, W, C, stream)
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {err}")
    profiling.count(f"launch.{what}")


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """Kernel P6: (N, C, H, W) -> (N, C, H/2, W/2), channels_last."""
    if x.device.type == "cpu":
        return maxpool2x2_plain(x)
    check_kernel_input(x, even_hw=True)
    N, C, H, W = x.shape
    y = torch.empty((N, C, H // 2, W // 2), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    _launch(x, y, "maxpool2x2")
    return y


def up2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Kernel P7: (N, C, h, w) -> (N, C, 2h, 2w), channels_last."""
    if x.device.type == "cpu":
        return up2x_nearest_plain(x)
    check_kernel_input(x, even_hw=False)
    N, C, h, w = x.shape
    y = torch.empty((N, C, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    _launch(x, y, "up2x_nearest")
    return y
