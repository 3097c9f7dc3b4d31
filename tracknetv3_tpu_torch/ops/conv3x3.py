"""SAME 3x3 convolution with the folded serving forward's bias + ReLU
epilogue (hand-written CUDA kernels for Hopper).

The JAX serving forward's ``_conv_relu`` convolves in the working dtype
with a float32 accumulator, adds the float32 bias to it, applies ReLU and
casts once. ``tools/probe_pallas_conv.py`` (``make_conv3x3``,
``make_conv3x3_wide``) and ``tools/probe_pallas_ablate.py`` hold the Pallas
implicit-GEMM kernels written for that convolution. Here they are the two
kernels of ``csrc/conv3x3.cu`` (TMA loads through an mbarrier ring, ``wgmma``
products, the epilogue on the accumulators, TMA stores):

- ``"k3c"``: the im2col-sheet kernel (one K = 3 * CK product per dy, A and B
  from shared memory);
- ``"9tap"``: nine K = CK products on shifted views of the halo tile, A
  loaded to registers by ``ldmatrix``, no sheet;

and the ablation probe's partial variants (``ABLATION_VARIANTS``), which are
timings with no defined output.

Tensors are NCHW views with channels_last memory (physically NHWC). The
weights are packed once by ``pack_weights``: the HWIO kernel reshaped to
(3, 3 * Ci, Co), rows (dx, ci) for each dy, with Ci padded to a multiple
of ``CI_MULTIPLE`` by zero rows (the first layer's 27 channels become 32; the
caller pads the input's channels alike). The kernels read channel chunks of
``CK``; the tensor maps' zero fill covers a last chunk past Ci, so Ci need
only give the 16-byte global stride that TMA takes. ``launch_plan`` computes
every size a launch passes to the C entry point: tiles, grid, shared memory,
the three tensor maps. On a CPU tensor ``conv3x3_bias_relu`` returns its
plain version (``conv3x3_bias_relu_plain``, any float dtype); on a CUDA
tensor it takes bfloat16 only and launches the kernel or raises.
``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

SOURCE = "conv3x3.cu"
VARIANTS = ("k3c", "9tap")
# the ablation probe's partial variants of the k3c kernel: C entry point suffix
ABLATION_VARIANTS = {"mm-only": "k3c_mm_only", "mm1-only": "k3c_mm1_only",
                     "dma+mm": "k3c_dma_mm", "sheet+mm": "k3c_sheet_mm"}
LAUNCHES = {"conv3x3_k3c": 0, "conv3x3_9tap": 0}
CI_MULTIPLE = 8  # input channels: TMA's 16-byte global stride
CO_MULTIPLE = 64  # output channels per 128-byte TMA box
TH, TW = 8, 16  # pixel tile at MW = 1; 8 MW rows: two warpgroups of MW m64 blocks of 4 x 16
CK = 64  # input channels per chunk: 128 bytes per pixel
SMEM_LIMIT = 232_448  # bytes of shared memory a block can use on the H100
# shared memory of one block (csrc/conv3x3.cu): buffers 1024-aligned, 1024
# bytes of slack to align the base, 128 for the mbarriers
W_BLOCK_BYTES = 3 * CK * 128  # one dy's three taps for 64 output channels
SHEET_BYTES = 3 * (TH // 2 + 2) * TW * 128  # one warpgroup's im2col sheet
STORE_BLOCK_BYTES = 4 * TW * 128  # one m64 block's output (64 pixels), 64 channels
WEIGHT_STAGES = {"k3c": 2, "9tap": 3}
# the order of the plan's int64s that the C entry points read (enum Plan)
PLAN_FIELDS = ("N", "H", "W", "Ci", "Co", "BN", "grid_x", "grid_y", "smem_bytes",
               "tiles_w", "tiles_h", "x_dims", "x_strides", "x_box", "w_dims", "w_strides",
               "w_box", "y_dims", "y_strides", "y_box")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """A TMA tensor map: dims innermost first (elements), byte strides of
    the outer dims, box (elements)."""
    dims: Tuple[int, ...]
    strides: Tuple[int, ...]
    box: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Everything a launch of ``conv3x3.cu`` passes in (``launch_plan``)."""
    N: int
    H: int
    W: int
    Ci: int
    Co: int
    BN: int  # output channels per block
    MW: int  # m64 blocks (64 pixels) per consumer warpgroup: the tile is 8 MW rows
    grid: Tuple[int, int]  # (pixel tiles, channel tiles)
    tiles: Tuple[int, int]  # (along W, along H)
    smem_bytes: int
    stage_bytes: Dict[str, int]  # each shared-memory buffer's bytes, and their counts
    x_map: TensorMap  # x (C, W, H, N): box = one chunk's halo tile
    w_map: TensorMap  # weights (Co, Ci, 9 taps): box = one dy's three taps
    y_map: TensorMap  # y (Co, W, H, N): box = one m64 block's output, 64 channels

    def to_int64(self) -> np.ndarray:
        vals = [self.N, self.H, self.W, self.Ci, self.Co, self.BN, *self.grid, self.smem_bytes,
                *self.tiles]
        for m in (self.x_map, self.w_map, self.y_map):
            vals += [*m.dims, *m.strides, *m.box]
        return np.asarray(vals, np.int64)


def launch_plan(N: int, H: int, W: int, Ci: int, Co: int, variant: str) -> LaunchPlan:
    """The launch of ``variant`` (``VARIANTS`` or ``ABLATION_VARIANTS``) on
    x (N, H, W, Ci) -> y (N, H, W, Co), bf16 NHWC; raises on shapes the
    kernels do not take."""
    if variant not in VARIANTS and variant not in ABLATION_VARIANTS:
        raise ValueError(f"unknown conv variant {variant!r}")
    if min(N, H, W, Ci, Co) <= 0 or Ci % CI_MULTIPLE or Co % CO_MULTIPLE:
        raise ValueError(f"need input channels a multiple of {CI_MULTIPLE} and output "
                         f"channels a multiple of {CO_MULTIPLE}, got {Ci} -> {Co}")
    bn = 128 if Co % 128 == 0 else 64
    if variant in ABLATION_VARIANTS and bn != 128:
        raise ValueError("the ablation variants are built for 128 output channels a block")
    k3c = variant != "9tap"
    mw = 1 if k3c or bn == 128 else 2  # 9tap at BN = 64: M = 256
    th = TH * mw
    tiles = (-(-W // TW), -(-H // th))
    stages = WEIGHT_STAGES["k3c" if k3c else "9tap"]
    per_wg = SHEET_BYTES if k3c else mw * bn // 64 * STORE_BLOCK_BYTES
    halo = CK * 2 * (TW + 2) * (th + 2)
    stage_bytes = {"halo_tile": halo, "halo_buffer": _round_up(halo, 1024),
                   "halo_buffers": 2, "weight_stage": bn // 64 * W_BLOCK_BYTES,
                   "weight_stages": stages, "per_warpgroup": per_wg, "warpgroups": 2,
                   "barriers": 128, "align_slack": 1024}
    smem = (stage_bytes["align_slack"] + 2 * stage_bytes["halo_buffer"] + 2 * per_wg
            + stages * stage_bytes["weight_stage"] + stage_bytes["barriers"])
    e = 2  # bytes of a bfloat16
    return LaunchPlan(
        N=N, H=H, W=W, Ci=Ci, Co=Co, BN=bn, MW=mw, grid=(N * tiles[0] * tiles[1], Co // bn),
        tiles=tiles, smem_bytes=smem, stage_bytes=stage_bytes,
        x_map=TensorMap((Ci, W, H, N), (Ci * e, W * Ci * e, H * W * Ci * e),
                        (CK, TW + 2, th + 2, 1)),
        w_map=TensorMap((Co, Ci, 9), (Co * e, Ci * Co * e), (64, CK, 3)),
        y_map=TensorMap((Co, W, H, N), (Co * e, W * Co * e, H * W * Co * e),
                        (64, TW, 4, 1)),
    )


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernels' C entry points."""
    lib = cuda_build.load(SOURCE)
    for name in VARIANTS + tuple(ABLATION_VARIANTS.values()):
        fn = getattr(lib, f"conv3x3_{name}_bf16")
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _P]
        fn.restype = _I
    return lib


def padded_channels(ci: int) -> int:
    """``ci`` rounded up to ``CI_MULTIPLE``."""
    return -(-ci // CI_MULTIPLE) * CI_MULTIPLE


def pack_weights(kernel_hwio: Union[np.ndarray, torch.Tensor], dtype: torch.dtype, *,
                 device: Union[str, torch.device]) -> torch.Tensor:
    """(3, 3, Ci, Co) HWIO kernel -> (3, 3 * Cp, Co) in ``dtype``: for each dy
    the rows (dx, ci), Cp = Ci padded to a multiple of ``CI_MULTIPLE`` with
    zero rows."""
    k = torch.as_tensor(kernel_hwio, dtype=torch.float32)
    if k.dim() != 4 or tuple(k.shape[:2]) != (3, 3):
        raise ValueError(f"need a (3, 3, Ci, Co) HWIO kernel, got {tuple(k.shape)}")
    ci, co = k.shape[2:]
    k = F.pad(k, (0, 0, 0, padded_channels(ci) - ci))
    return k.reshape(3, -1, co).to(device, dtype).contiguous()


def _check_operands(x: torch.Tensor, packed: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if x.dim() != 4 or packed.dim() != 3 or packed.shape[0] != 3:
        raise ValueError(f"need x (N, C, H, W) and packed weights (3, 3 * C, Co), got "
                         f"{tuple(x.shape)} and {tuple(packed.shape)}")
    if packed.shape[1] != 3 * x.shape[1]:
        raise ValueError(f"x has {x.shape[1]} channels, the packed weights "
                         f"{packed.shape[1]} / 3 (pad the input's channels as pack_weights "
                         f"pads the kernel's)")
    if packed.dtype != x.dtype or packed.device != x.device:
        raise ValueError(f"weights are {packed.dtype} on {packed.device}, x is {x.dtype} on "
                         f"{x.device}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != packed.shape[2:]
                             or bias.device != x.device):
        raise ValueError(f"need a float32 bias of shape ({packed.shape[2]},) on {x.device}, "
                         f"got {bias.dtype} {tuple(bias.shape)} on {bias.device}")


def conv3x3_bias_relu_plain(x: torch.Tensor, packed: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, *,
                            relu: bool = True) -> torch.Tensor:
    """The function in plain PyTorch: ``F.conv2d`` on float32 copies
    (``padding=1``), the float32 bias, a NaN-propagating ReLU, one cast to
    ``x.dtype``; channels_last. On the card it runs PyTorch's own
    (non-cuDNN) float32 convolution, so no TF32 and no transform algorithm
    that would spread a NaN or an inf past its 3x3 neighbourhood."""
    _check_operands(x, packed, bias)
    co = packed.shape[2]
    w = packed.reshape(3, 3, -1, co).permute(3, 2, 0, 1).float()
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x.float(), w, padding=1)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    if relu:
        y = torch.maximum(y, torch.zeros((), device=y.device))
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def bf16_ulps_apart(a: torch.Tensor, b: torch.Tensor, floor: float) -> float:
    """Largest ``|a - b|`` over the entries finite in both, in units of the
    bfloat16 spacing at ``max(|a|, |b|, floor)``. Two float32 sums of the
    same terms in different orders, each rounded once to bfloat16, are at
    most 1 apart wherever the result is not a cancellation far below the
    size of the sums; ``floor`` (a fraction of the output's RMS) sets the
    spacing that such entries are held to."""
    a, b = a.float(), b.float()
    ok = torch.isfinite(a) & torch.isfinite(b)
    if not bool(ok.any()):
        return 0.0
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(floor)
    spacing = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return float(((a - b).abs() / spacing)[ok].max())


def check_kernel_input(x: torch.Tensor, packed: torch.Tensor,
                       bias: Optional[torch.Tensor]) -> None:
    """Raise unless the operands are what the kernels take: bfloat16 x, an
    NCHW view of channels_last memory with a multiple of ``CI_MULTIPLE``
    channels; contiguous bfloat16 packed weights with a multiple of
    ``CO_MULTIPLE`` output channels; a contiguous float32 bias or None;
    16-byte aligned (TMA's global addresses)."""
    _check_operands(x, packed, bias)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the conv kernels take bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("need channels_last (NHWC) memory")
    if x.shape[1] % CI_MULTIPLE or packed.shape[2] % CO_MULTIPLE:
        raise ValueError(f"need input channels a multiple of {CI_MULTIPLE} and output "
                         f"channels a multiple of {CO_MULTIPLE}, got {x.shape[1]} -> "
                         f"{packed.shape[2]}")
    if not packed.is_contiguous() or (bias is not None and not bias.is_contiguous()):
        raise ValueError("need contiguous packed weights and bias")
    ptrs = [x.data_ptr(), packed.data_ptr()] + ([bias.data_ptr()] if bias is not None else [])
    if any(p % 16 for p in ptrs):
        raise ValueError("need 16-byte aligned tensors")


def _launch(entry: str, variant: str, x: torch.Tensor, packed: torch.Tensor,
            bias: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """Check, plan, allocate y, launch the C entry point ``conv3x3_<entry>_bf16``."""
    check_kernel_input(x, packed, bias)
    N, C, H, W = x.shape
    co = packed.shape[2]
    plan = launch_plan(N, H, W, C, co, variant).to_int64()
    y = torch.empty((N, co, H, W), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    fn = getattr(_lib(), f"conv3x3_{entry}_bf16")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), packed.data_ptr(), None if bias is None else bias.data_ptr(),
                 y.data_ptr(), plan.ctypes.data, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_{entry} failed to launch: error {err} (cudaError, or "
                           f"10000 + the CUresult of a tensor map)")
    return y


def conv3x3_bias_relu(x: torch.Tensor, packed: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, *, variant: str,
                      relu: bool = True) -> torch.Tensor:
    """Kernels P1-P3: (N, C, H, W) -> (N, Co, H, W), channels_last,
    ``cast(relu(conv(x) + bias))`` with one rounding. ``bias=None,
    relu=False`` gives the bare conv. ``variant`` is ``"k3c"`` or ``"9tap"``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown conv variant {variant!r}, need one of {VARIANTS}")
    if x.device.type == "cpu":
        return conv3x3_bias_relu_plain(x, packed, bias, relu=relu)
    y = _launch(variant, variant, x, packed, bias, relu)
    LAUNCHES[f"conv3x3_{variant}"] += 1
    return y


def conv3x3_ablation(x: torch.Tensor, packed: torch.Tensor, *, variant: str) -> torch.Tensor:
    """One of the ablation probe's partial variants of the k3c kernel on the
    card (``ABLATION_VARIANTS``): for timing only, the output is no conv."""
    return _launch(ABLATION_VARIANTS[variant], variant, x, packed, None, False)
