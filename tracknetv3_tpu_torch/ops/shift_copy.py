"""Window, repeat and roll copies of frame stacks and NHWC tiles (hand-written
CUDA kernels).

``tools/probe_mosaic_caps.py`` of the JAX package holds seven Pallas probes
(U1-U7) of the shifted copies an NHWC tile needs: a leading-dimension window
at a free offset, the same with a column offset or a channel range, an
interleaved row repeat, a roll by one column. The JAX train step's input
assembly (``tracknetv3_tpu/training/steps.py``) does the first and the
repeat on the device: the overlapping windows of a segmented batch, the
per-segment median repeat, the gather of device-resident frames by flat
index, the two gathers of the frame-mixup blend. Here they are the three
kernels of ``csrc/shift_copy.cu``:

- ``window_copy(x, starts, rows, col0, cols, ch0, chs, staged)``:
  ``out[i, t, ..., w, c] = x[starts[i] + t, ..., col0 + w, ch0 + c]``
  (U1; U2 and U7 with ``col0=1``; U3 the same through ``staged``, which
  slices a shared-memory copy of the row; U4 with ``ch0=128, chs=128``);
- ``repeat_rows(x, k)``: ``out[r * k + j] = x[r]`` (U5: interleaved, as
  ``np.repeat``, not tiled);
- ``roll_cols(x, shift)``: ``out[..., w, :] = x[..., (w - shift) % W, :]`` (U6).

All three are copies: every bit of an element is kept, whatever its type
(any dtype of 1, 2 or 4 bytes). The kernels work in bytes with the widest
vector (16 down to 1 byte) that divides every pointer, stride, offset and
extent of the launch; ``vector_bytes`` chooses it here, where the CPU tests
reach it.

On a CPU tensor each wrapper returns its plain version (``*_plain``: torch
indexing, ``repeat_interleave``, ``torch.roll``); on a CUDA tensor it
launches its kernel or raises. ``LAUNCHES`` counts the launches of each
kernel. A window start that is out of range is the caller's to refuse on
the host (``check_starts`` on the numpy indices, before upload): reading a
device table back would put a synchronisation into the train step.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import cuda_build

SOURCE = "shift_copy.cu"
LAUNCHES = {"window_copy": 0, "repeat_rows": 0, "roll_cols": 0}
TILE_BYTES = 32768  # the staged variant's shared tile (kTileBytes of the source)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernels' C entry points."""
    lib = cuda_build.load(SOURCE)
    lib.shift_copy_tile_bytes.argtypes = []
    lib.shift_copy_tile_bytes.restype = _I
    lib.window_copy.argtypes = [_P, _P, _I, _P] + [_LL] * 8 + [_I, _I, _P]
    lib.repeat_rows.argtypes = [_P, _P, _LL, _LL, _LL, _I, _P]
    lib.roll_cols.argtypes = [_P, _P, _LL, _LL, _LL, _LL, _I, _P]
    for fn in (lib.window_copy, lib.repeat_rows, lib.roll_cols):
        fn.restype = _I
    if lib.shift_copy_tile_bytes() != TILE_BYTES:
        raise RuntimeError("csrc/shift_copy.cu and ops/shift_copy.py disagree on the tile size")
    return lib


def vector_bytes(*quantities: int) -> int:
    """The widest vector (16, 8, 4, 2 or 1 bytes) that divides every given
    byte quantity: base pointers, strides, offsets and extents of a launch."""
    for v in (16, 8, 4, 2):
        if all(q % v == 0 for q in quantities):
            return v
    return 1


# ---------------------------------------------------------------- plain versions


def window_copy_plain(x: torch.Tensor, starts: torch.Tensor, rows: int, col0: int = 0,
                      cols: Optional[int] = None, ch0: int = 0,
                      chs: Optional[int] = None) -> torch.Tensor:
    """``x[starts[i] + t]`` for ``t < rows``, then the column and channel
    ranges: (n, rows, ..., cols, chs). Torch indexing."""
    cols = x.shape[-2] - col0 if cols is None else cols
    chs = x.shape[-1] - ch0 if chs is None else chs
    idx = starts.long()[:, None] + torch.arange(rows, device=x.device)[None, :]
    return x[idx][..., col0 : col0 + cols, ch0 : ch0 + chs].contiguous()


def repeat_rows_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each row of ``x`` ``k`` times in a row (interleaved): (R * k, ...)."""
    return x.repeat_interleave(k, dim=0)


def roll_cols_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``x`` rolled by ``shift`` along its second-to-last axis."""
    return torch.roll(x, shift, dims=-2)


# ---------------------------------------------------------------- input checks


def check_starts(starts, rows: int, n_rows: int) -> None:
    """Raise ``IndexError`` unless every window ``[start, start + rows)`` lies
    inside ``[0, n_rows)``. ``starts`` is a numpy array or a CPU tensor: the
    loaders call this on their indices before they go to the card."""
    s = np.asarray(starts)
    if s.size and (int(s.min()) < 0 or int(s.max()) + rows > n_rows):
        raise IndexError(f"window starts in [{int(s.min())}, {int(s.max())}] with {rows} rows "
                         f"leave the {n_rows} rows of the source")


def check_kernel_input(x: torch.Tensor) -> None:
    """Raise unless ``x`` is what the kernels take: a contiguous CUDA tensor
    of at least 2 dimensions whose elements have 1, 2 or 4 bytes."""
    if x.device.type != "cuda":
        raise ValueError(f"the copy kernels need a CUDA tensor, got {x.device}")
    if x.dim() < 2 or x.element_size() not in (1, 2, 4):
        raise ValueError(f"need a tensor of 2 or more dimensions with 1-, 2- or 4-byte "
                         f"elements, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("need a contiguous tensor")


class WindowGeometry(NamedTuple):
    """``window_copy``'s launch in the kernel's terms: ``x`` as (R, W, pixels
    of ``pix_bytes``), the column range in pixels, the channel range in bytes."""

    W: int
    pix_bytes: int
    col0: int
    cols: int
    ch0_bytes: int
    chs_bytes: int
    out_shape: Tuple[int, ...]

    def byte_quantities(self, staged: bool) -> Tuple[int, ...]:
        """What the vector width must divide (beside the base pointers)."""
        whole = self.chs_bytes == self.pix_bytes
        seg_bytes = self.cols * self.pix_bytes if whole else self.chs_bytes
        q = (self.W * self.pix_bytes, self.col0 * self.pix_bytes + self.ch0_bytes, seg_bytes)
        if not whole:
            q += (self.pix_bytes,)
        if staged:
            q += (self.pix_bytes, self.ch0_bytes, self.chs_bytes)
        return q


def window_geometry(shape: Tuple[int, ...], element_size: int, n: int, rows: int, col0: int,
                    cols: Optional[int], ch0: int, chs: Optional[int]) -> WindowGeometry:
    """Check the ranges against ``shape`` = (R, ..., W, C) and fold them into
    the kernel's (R, W, pixel) view. A whole-row copy is one pixel of the
    row's bytes; a column or channel range needs a 3-D ``x``."""
    W, C = shape[-2], shape[-1]
    cols = W - col0 if cols is None else cols
    chs = C - ch0 if chs is None else chs
    if rows < 1 or col0 < 0 or cols < 1 or col0 + cols > W or ch0 < 0 or chs < 1 or ch0 + chs > C:
        raise ValueError(f"rows {rows}, columns [{col0}, {col0 + cols}), channels "
                         f"[{ch0}, {ch0 + chs}) do not fit {tuple(shape)}")
    out_shape = (n, rows) + tuple(shape[1:-2]) + (cols, chs)
    if cols == W and chs == C:
        row_bytes = math.prod(shape[1:]) * element_size
        return WindowGeometry(1, row_bytes, 0, 1, 0, row_bytes, out_shape)
    if len(shape) != 3:
        raise ValueError(f"a column or channel range needs a 3-D (R, W, C) tensor, got "
                         f"{tuple(shape)}")
    return WindowGeometry(W, C * element_size, col0, cols, ch0 * element_size,
                          chs * element_size, out_shape)


def _check_starts_tensor(x: torch.Tensor, starts: torch.Tensor) -> None:
    if starts.dim() != 1 or starts.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"starts must be a 1-D int32 or int64 tensor, got {starts.dtype} "
                         f"{tuple(starts.shape)}")
    if starts.device != x.device or not starts.is_contiguous():
        raise ValueError("starts must be contiguous and on the source's device")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {err}")


# ---------------------------------------------------------------- wrappers


def window_copy(x: torch.Tensor, starts: torch.Tensor, rows: int, col0: int = 0,
                cols: Optional[int] = None, ch0: int = 0, chs: Optional[int] = None,
                staged: bool = False) -> torch.Tensor:
    """Kernel ``window_copy``: ``x`` (R, ..., W, C), ``starts`` (n,) int32 or
    int64 on ``x``'s device -> (n, rows, ..., cols, chs) with
    ``out[i, t] = x[starts[i] + t, ..., col0:col0 + cols, ch0:ch0 + chs]``.
    ``staged`` slices a shared-memory copy of each row instead of the global
    load (a pixel must fit the 32 KB tile). On the card the starts are not
    read back: the caller has checked them (``check_starts``)."""
    _check_starts_tensor(x, starts)
    if x.device.type == "cpu":
        check_starts(starts, rows, x.shape[0])
        return window_copy_plain(x, starts, rows, col0, cols, ch0, chs)
    check_kernel_input(x)
    n = starts.shape[0]
    g = window_geometry(tuple(x.shape), x.element_size(), n, rows, col0, cols, ch0, chs)
    if staged and g.pix_bytes > TILE_BYTES:
        raise ValueError(f"staged needs a pixel of at most {TILE_BYTES} bytes, got "
                         f"{g.pix_bytes} (a whole-row copy is one pixel)")
    out = torch.empty(g.out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec = vector_bytes(x.data_ptr(), out.data_ptr(), *g.byte_quantities(staged))
    with torch.cuda.device(x.device):
        err = _lib().window_copy(
            x.data_ptr(), starts.data_ptr(), int(starts.dtype == torch.int64), out.data_ptr(),
            n, rows, g.W, g.pix_bytes, g.col0, g.cols, g.ch0_bytes, g.chs_bytes,
            int(staged), vec, _stream(x),
        )
    _raise_on(err, "window_copy")
    LAUNCHES["window_copy"] += 1
    return out


def repeat_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel ``repeat_rows``: (R, ...) -> (R * k, ...), each row ``k`` times
    in a row."""
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    if x.device.type == "cpu":
        return repeat_rows_plain(x, k)
    check_kernel_input(x)
    out = torch.empty((x.shape[0] * k,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    row_bytes = math.prod(x.shape[1:]) * x.element_size()
    vec = vector_bytes(x.data_ptr(), out.data_ptr(), row_bytes)
    with torch.cuda.device(x.device):
        err = _lib().repeat_rows(x.data_ptr(), out.data_ptr(), x.shape[0], row_bytes, k, vec,
                                 _stream(x))
    _raise_on(err, "repeat_rows")
    LAUNCHES["repeat_rows"] += 1
    return out


def roll_cols(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Kernel ``roll_cols``: (..., W, C) rolled by ``shift`` columns (any
    sign) along the second-to-last axis."""
    if x.device.type == "cpu":
        return roll_cols_plain(x, shift)
    check_kernel_input(x)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    W = x.shape[-2]
    pix_bytes = x.shape[-1] * x.element_size()
    vec = vector_bytes(x.data_ptr(), out.data_ptr(), pix_bytes)
    with torch.cuda.device(x.device):
        err = _lib().roll_cols(x.data_ptr(), out.data_ptr(), x.numel() // (W * x.shape[-1]), W,
                               pix_bytes, shift % W, vec, _stream(x))
    _raise_on(err, "roll_cols")
    LAUNCHES["roll_cols"] += 1
    return out
