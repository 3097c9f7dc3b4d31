"""Fused WBCE loss against *virtual* disk labels (hand-written CUDA kernels).

The TrackNet training loss compares sigmoid heatmaps with binary-disk
labels. Composed from plain ops it materialises the (B, H, W, L) label
tensor and keeps the sigmoid alive for the backward. The kernels in
``csrc/wbce_disk.cu`` build the label membership on the fly from integer
centers, in one pass over the logits forward and one pass backward.
Labels take the blended form

    y = w * disk(center_a) + (1 - w) * disk(center_b)

which covers plain training (a == b, w == 1), sample mixup (b = centers
of the permuted sample, w = lambda) and frame mixup (two carried centers).

``wbce_disk_loss`` has the JAX package's signature
(``tracknetv3_tpu/ops/pallas_wbce.py::wbce_disk_loss``): logits
(B, H, W, L), centers (B, 2, 2, L), weights (B, 1, L). On a CPU tensor it
runs ``wbce_disk_loss_plain`` (``make_heatmaps`` + ``wbce_from_logits``);
on a CUDA tensor it launches the kernels or raises. ``LAUNCHES`` counts
the launches of each direction.

The forward (K1) is one launch of a persistent grid whose warps walk a
fixed partition of the logits into rows (``loss_plan``): one float partial
per row, summed in double by the last block to finish, so the loss is the
same bits from run to run and does not depend on the card. Its scratch (the
partials and the last block's ticket) is kept per device and stream, and
its plan per shape and card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import SIGMA
from . import cuda_build
from .heatmap import make_heatmaps
from .losses import wbce_from_logits

SOURCE = "wbce_disk.cu"
LAUNCHES = {"fwd": 0, "bwd": 0}
# K1's constants (csrc/wbce_disk.cu): threads per block (8 warps), blocks
# per SM (the launch bounds)
THREADS, BLOCKS_PER_SM = 256, 4
WARPS = THREADS // 32
# the order of the plan's int64s that the C entry point reads (enum Plan)
PLAN_FIELDS = ("items", "grid", "threads")

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernels' C entry points."""
    lib = cuda_build.load(SOURCE)
    lib.wbce_disk_constants.argtypes = [_P]
    lib.wbce_disk_constants.restype = _I
    lib.wbce_disk_forward.argtypes = [_P] * 6 + [_I] * 4 + [ctypes.c_float, _P, _P]
    lib.wbce_disk_backward.argtypes = [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P]
    for fn in (lib.wbce_disk_forward, lib.wbce_disk_backward):
        fn.restype = _I
    consts = (ctypes.c_longlong * 3)()
    lib.wbce_disk_constants(consts)
    if tuple(consts) != (THREADS, BLOCKS_PER_SM, len(PLAN_FIELDS)):
        raise RuntimeError("csrc/wbce_disk.cu and ops/wbce_disk.py disagree on their constants")
    return lib


@dataclasses.dataclass(frozen=True)
class LossPlan:
    """K1's launch: ``items`` work items, one per row of a (sample, frame)
    plane, walked by the ``grid * WARPS`` warps in even contiguous shares."""

    items: int
    grid: int
    threads: int = THREADS

    def as_array(self) -> np.ndarray:
        return np.array([getattr(self, f) for f in PLAN_FIELDS], dtype=np.int64)

    def warp_items(self, gw: int) -> range:
        """The rows warp ``gw`` of the grid walks, as the kernel computes them."""
        warps = self.grid * WARPS
        return range(gw * self.items // warps, (gw + 1) * self.items // warps)


def loss_plan(B: int, L: int, H: int, W: int, num_sms: int) -> LossPlan:
    """K1's partition and grid. An item is one row of one plane: B*L*H
    items, a count that depends on the shape alone, so the loss does not
    depend on the card. The grid is ``num_sms * BLOCKS_PER_SM`` blocks, or
    one warp per row where there are fewer rows. Raises where no launch
    fits: an empty shape, W not a multiple of 4 (the float4 loads)."""
    if min(B, L, H, W) < 1:
        raise ValueError(f"empty logits {(B, L, H, W)}")
    if W % 4:
        raise ValueError(f"the forward kernel needs W a multiple of 4, got {W}")
    items = B * L * H
    return LossPlan(items, min(num_sms * BLOCKS_PER_SM, -(-items // WARPS)))


@functools.lru_cache(maxsize=64)
def _plan_array(B: int, L: int, H: int, W: int, num_sms: int) -> Tuple[LossPlan, np.ndarray]:
    """``loss_plan`` and the int64s the C entry point reads, kept per shape
    and card: a train step asks for the same launch every time."""
    plan = loss_plan(B, L, H, W, num_sms)
    return plan, plan.as_array()


# (device index, stream) -> (partials, ticket): K1's scratch. The ticket is
# 0 between launches (the last block resets it); launches on one stream run
# in order, so they may share it.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, items: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    have = _SCRATCH.get(key)
    if have is None or have[0].numel() < items:
        have = (torch.empty(items, dtype=torch.float32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device))
        _SCRATCH[key] = have
    return have


def _check(z: torch.Tensor, centers: torch.Tensor, w: torch.Tensor) -> None:
    if z.device.type != "cuda":
        raise ValueError(f"wbce_disk kernels need a CUDA tensor, got {z.device}")
    if z.dtype != torch.float32 or z.dim() != 4 or not z.is_contiguous():
        raise ValueError(
            f"logits must be contiguous float32 (B, L, H, W), got {z.dtype} "
            f"{tuple(z.shape)} contiguous={z.is_contiguous()}"
        )
    B, L = z.shape[:2]
    if centers.dtype != torch.int32 or tuple(centers.shape) != (B, 4 * L):
        raise ValueError(f"centers must be int32 (B, 4L), got {centers.dtype} {tuple(centers.shape)}")
    if w.dtype != torch.float32 or tuple(w.shape) != (B, L):
        raise ValueError(f"weights must be float32 (B, L), got {w.dtype} {tuple(w.shape)}")
    for t in (centers, w):
        if t.device != z.device or not t.is_contiguous():
            raise ValueError("targets must be contiguous and on the logits' device")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {err}")


def wbce_disk_forward(z: torch.Tensor, centers: torch.Tensor, w: torch.Tensor,
                      sigma: float = SIGMA) -> torch.Tensor:
    """Kernel K1: mean WBCE of ``z`` (B, L, H, W) -> 0-d float32 tensor, in
    one launch."""
    _check(z, centers, w)
    if z.data_ptr() % 16:
        raise ValueError("the forward kernel needs 16-byte aligned logits")
    B, L, H, W = z.shape
    plan, arr = _plan_array(B, L, H, W, cuda_build.num_sms(z.device))
    loss = torch.empty((), device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        partials, ticket = _scratch(z.device, stream, plan.items)
        err = _lib().wbce_disk_forward(
            z.data_ptr(), centers.data_ptr(), w.data_ptr(), partials.data_ptr(),
            ticket.data_ptr(), loss.data_ptr(), B, L, H, W, float(sigma), arr.ctypes.data,
            stream,
        )
    _raise_on(err, "wbce_disk_forward")
    LAUNCHES["fwd"] += 1
    return loss


def wbce_disk_backward(z: torch.Tensor, centers: torch.Tensor, w: torch.Tensor,
                       g: torch.Tensor, sigma: float = SIGMA) -> torch.Tensor:
    """Kernel K2: dL/dz (B, L, H, W) scaled by the device scalar ``g``."""
    _check(z, centers, w)
    B, L, H, W = z.shape
    g = g.to(torch.float32).reshape(1).contiguous()
    dz = torch.empty_like(z)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = _lib().wbce_disk_backward(
            z.data_ptr(), centers.data_ptr(), w.data_ptr(), g.data_ptr(),
            dz.data_ptr(), B, L, H, W, float(sigma), stream,
        )
    _raise_on(err, "wbce_disk_backward")
    LAUNCHES["bwd"] += 1
    return dz


class _WbceDisk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, centers, w, sigma):
        z = logits.movedim(-1, 1).contiguous()  # a view of NCHW logits: no copy
        ctx.save_for_backward(z, centers, w)
        ctx.sigma = sigma
        return wbce_disk_forward(z, centers, w, sigma)

    @staticmethod
    def backward(ctx, g):
        z, centers, w = ctx.saved_tensors
        dz = wbce_disk_backward(z, centers, w, g, ctx.sigma)
        return dz.movedim(1, -1), None, None, None


def flatten_targets(cxcy2: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 2, 2, L) centers + (B, 1, L) weights -> the kernels' layouts:
    (B, 4L) int32 [cxa | cya | cxb | cyb] and (B, L) float32."""
    B, _, _, L = cxcy2.shape
    flat = torch.cat(
        [cxcy2[:, 0, 0], cxcy2[:, 0, 1], cxcy2[:, 1, 0], cxcy2[:, 1, 1]], dim=-1
    )
    return flat.to(torch.int32).contiguous(), w.reshape(B, L).to(torch.float32).contiguous()


def wbce_disk_loss_plain(logits: torch.Tensor, cxcy2: torch.Tensor, w: torch.Tensor,
                         sigma: float = SIGMA) -> torch.Tensor:
    """The kernels' function from plain ops: materialised blended labels
    (``make_heatmaps``) and ``wbce_from_logits``, differentiated by autograd."""
    B, H, W, L = logits.shape
    return wbce_from_logits(logits, disk_labels_plain(cxcy2, w, H, W, sigma))


def disk_labels_plain(cxcy2: torch.Tensor, w: torch.Tensor, H: int, W: int,
                      sigma: float = SIGMA) -> torch.Tensor:
    """The blended two-disk labels the kernels build on the fly, materialised:
    (B, H, W, L) float32."""
    B, L = cxcy2.shape[0], cxcy2.shape[-1]
    map_a = make_heatmaps(cxcy2[:, 0, 0], cxcy2[:, 0, 1], H, W, sigma)  # (B, L, H, W)
    map_b = make_heatmaps(cxcy2[:, 1, 0], cxcy2[:, 1, 1], H, W, sigma)
    wa = w.reshape(B, L, 1, 1).float()
    return (map_a * wa + map_b * (1.0 - wa)).movedim(1, -1)


def wbce_disk_loss(logits: torch.Tensor, cxcy2: torch.Tensor, w: torch.Tensor,
                   sigma: float = SIGMA) -> torch.Tensor:
    """Mean WBCE of ``logits`` vs blended virtual disk labels.

    Args:
        logits: (B, H, W, L) float32 heatmap logits.
        cxcy2: (B, 2, 2, L) int centers; [:, 0] = (cx, cy) of disk A,
            [:, 1] = disk B. (0, 0) means "no ball".
        w: (B, 1, L) float blend weight of disk A (1.0 = only A).
        sigma: disk radius.
    """
    if logits.device.type == "cpu":
        return wbce_disk_loss_plain(logits, cxcy2, w, sigma)
    centers, wf = flatten_targets(cxcy2, w)
    return _WbceDisk.apply(logits, centers, wf, float(sigma))


def pack_plain_targets(cxcy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L, 2) int centers -> (cxcy2, w) for the un-mixed case."""
    c = cxcy.movedim(-1, 1).to(torch.int32)  # (B, 2, L)
    w = torch.ones(cxcy.shape[0], 1, cxcy.shape[1], dtype=torch.float32, device=cxcy.device)
    return torch.stack([c, c], dim=1), w


def pack_mixup_targets(cxcy: torch.Tensor, perm: torch.Tensor, lam: torch.Tensor,
                       partners: Optional[torch.Tensor] = None):
    """Sample mixup: disk A = own centers, disk B = the permuted sample's
    centers (``partners``, (B, L, 2), where they lie outside ``cxcy``),
    weight = the per-sample lambda."""
    c = cxcy.movedim(-1, 1).to(torch.int32)
    B, L = cxcy.shape[:2]
    w = lam.to(torch.float32)[:, None, None].expand(B, 1, L)
    b = c[perm] if partners is None else partners.movedim(-1, 1).to(torch.int32)
    return torch.stack([c, b], dim=1), w


def pack_frame_mixup_targets(mix_centers: torch.Tensor, mix_hm_w: torch.Tensor):
    """Frame mixup from the loader's blend plan (mix_centers (B, L, 2, 2),
    mix_hm_w (B, L))."""
    c = mix_centers.movedim(1, -1).to(torch.int32)  # (B, 2, 2, L)
    return c, mix_hm_w.to(torch.float32)[:, None, :]
