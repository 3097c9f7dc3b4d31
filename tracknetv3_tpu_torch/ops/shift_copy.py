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
reach it. ``copy_plan`` chooses ``window_copy``'s route from the launch's
geometry and computes every size the launch passes in: ``"bulk"`` for a
large copy of whole rows whose pointers and strides are multiples of 16
bytes (a persistent grid whose blocks take even shares of the output's
bytes and walk them in pieces through a ring of 1-D bulk TMA copies),
``"staged"`` where asked, ``"vector"`` otherwise. ``repeat_plan`` sizes
``repeat_rows``' pieces, each loaded once and stored k times, so that its
grid puts about one block on each SM. ``LAST_PLAN`` is the plan of the last
``window_copy`` or ``repeat_rows`` launch.

On a CPU tensor each wrapper returns its plain version (``*_plain``: torch
indexing, ``repeat_interleave``, ``torch.roll``); on a CUDA tensor it
launches its kernel or raises. Each launch counts under ``launch.<kernel>``
(``utils/profiling``). A window start that is out of range is the caller's
to refuse on the host (``check_starts`` on the numpy indices, before
upload): reading a device table back would put a synchronisation into the
train step.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..utils import profiling
from . import cuda_build

SOURCE = "shift_copy.cu"
KERNELS = ("window_copy", "repeat_rows", "roll_cols")  # launch counters
profiling.declare(*(f"launch.{k}" for k in KERNELS))
TILE_BYTES = 32768  # the staged variant's largest shared tile (kTileBytes of the source)
THREADS, UNROLL = 256, 4  # the vector body: a block copies THREADS * UNROLL vectors
# the bulk route (the source's constants): a ring of STAGES stages of at most
# MAX_STAGE_BYTES, loads issued LAG pieces ahead, one-warp blocks, at most
# MAX_BULK_BLOCKS_PER_SM of them per SM, the stages' mbarriers in the first
# BARRIER_BYTES of shared memory
STAGES, LAG, MAX_STAGE_BYTES = 4, 3, 24576
BULK_THREADS, MAX_BULK_BLOCKS_PER_SM, BARRIER_BYTES = 32, 4, 128
ROUTES = {"vector": 0, "staged": 1, "bulk": 2}  # enum Route of the source
# the order of the plan's int64s that the C entry point reads (enum Plan)
PLAN_FIELDS = ("route", "vec", "blocks_per_row", "tile_pix", "unit_bytes", "units_per_row",
               "chunk_units", "units", "stage_bytes", "grid", "threads", "smem_bytes",
               "blocks_per_sm")

# repeat_rows' plan: the order of its int64s (enum RepeatPlan of the source)
# and the unrolls the source instantiates, widest first
REPEAT_PLAN_FIELDS = ("vec", "unroll", "chunks_per_row", "grid", "threads")
REPEAT_UNROLLS = (8, 4, 2, 1)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernels' C entry points."""
    lib = cuda_build.load(SOURCE)
    lib.shift_copy_constants.argtypes = [_P]
    lib.shift_copy_constants.restype = _I
    lib.window_copy.argtypes = [_P, _P, _I, _P] + [_LL] * 8 + [_P, _P]
    lib.repeat_rows.argtypes = [_P, _P, _LL, _LL, _LL, _P, _P]
    lib.roll_cols.argtypes = [_P, _P, _LL, _LL, _LL, _LL, _I, _P]
    for fn in (lib.window_copy, lib.repeat_rows, lib.roll_cols):
        fn.restype = _I
    ours = (TILE_BYTES, THREADS, UNROLL, STAGES, MAX_STAGE_BYTES, BULK_THREADS,
            MAX_BULK_BLOCKS_PER_SM, BARRIER_BYTES, LAG, len(PLAN_FIELDS), len(REPEAT_PLAN_FIELDS))
    consts = (ctypes.c_longlong * len(ours))()
    lib.shift_copy_constants(consts)
    if tuple(consts) != ours:
        raise RuntimeError("csrc/shift_copy.cu and ops/shift_copy.py disagree on their constants")
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

    def runs(self) -> Tuple[int, int, int, int]:
        """An output row as contiguous source runs: (segs, seg_bytes,
        seg_stride, off0): ``segs`` runs of ``seg_bytes``, the s-th at byte
        ``off0 + s * seg_stride`` of the source row. Whole pixels are one run;
        a channel range is one run per pixel."""
        off0 = self.col0 * self.pix_bytes + self.ch0_bytes
        if self.chs_bytes == self.pix_bytes:
            return 1, self.cols * self.pix_bytes, 0, off0
        return self.cols, self.chs_bytes, self.pix_bytes, off0

    def byte_quantities(self, staged: bool) -> Tuple[int, ...]:
        """What the vector width must divide (beside the base pointers)."""
        segs, seg_bytes, seg_stride, off0 = self.runs()
        q = (self.W * self.pix_bytes, off0, seg_bytes)
        if segs > 1:
            q += (seg_stride,)
        if staged:
            q += (self.pix_bytes, self.ch0_bytes, self.chs_bytes)
        return q


@functools.lru_cache(maxsize=256)
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


@dataclasses.dataclass(frozen=True)
class CopyPlan:
    """``window_copy``'s launch: its route and every size the C entry point
    checks. ``vector`` / ``staged``: ``blocks_per_row`` blocks of THREADS per
    output row (``staged``: each slices a tile of ``tile_pix`` pixels).
    ``bulk``: the output as ``units`` units of ``unit_bytes`` (16 to 128
    bytes of a row; ``units_per_row`` a row), split into ``grid`` even
    contiguous shares, one per one-warp block, each walked in pieces of up
    to ``chunk_units`` units that end at a row's end."""

    route: str
    vec: int
    blocks_per_row: int = 0
    tile_pix: int = 0
    unit_bytes: int = 0
    units_per_row: int = 0
    chunk_units: int = 0
    units: int = 0
    stage_bytes: int = 0
    grid: int = 0
    threads: int = THREADS
    smem_bytes: int = 0
    blocks_per_sm: int = 0

    def as_array(self) -> np.ndarray:
        return np.array([ROUTES[self.route] if f == "route" else getattr(self, f)
                         for f in PLAN_FIELDS], dtype=np.int64)

    def block_units(self, b: int) -> range:
        """The units block ``b`` of a bulk launch moves, as the kernel computes them."""
        return range(b * self.units // self.grid, (b + 1) * self.units // self.grid)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _bulk_plan(g: WindowGeometry, out_rows: int, x_ptr: int, out_ptr: int,
               num_sms: int) -> Optional[CopyPlan]:
    """The bulk route's plan, or None where it does not apply: a channel
    range (runs shorter than the row), a pointer, offset or stride off the
    16-byte grid, or a copy too small for the ring to fill (fewer than
    STAGES full pieces a block: there the vector body measured faster)."""
    segs, _, _, off0 = g.runs()
    out_row_bytes = g.cols * g.chs_bytes
    quantities = (x_ptr, out_ptr, g.W * g.pix_bytes, off0, out_row_bytes)
    if segs != 1 or any(q % 16 for q in quantities):
        return None
    # the widest unit up to 128 bytes on which every share and piece starts:
    # a bulk copy that starts off a 128-byte line is slower
    unit = next(u for u in (128, 64, 32, 16) if all(q % u == 0 for q in quantities))
    upr = out_row_bytes // unit
    chunk_units = min(upr, MAX_STAGE_BYTES // unit)
    units = out_rows * upr
    stage = _round_up(chunk_units * unit, 128)
    smem = BARRIER_BYTES + STAGES * stage
    per_sm = min(MAX_BULK_BLOCKS_PER_SM, cuda_build.SMEM_PER_SM // (smem + 1024))
    grid = min(units, num_sms * per_sm)
    if units < grid * STAGES * chunk_units:
        return None
    return CopyPlan("bulk", 16, unit_bytes=unit, units_per_row=upr, chunk_units=chunk_units,
                    units=units, stage_bytes=stage, grid=grid, threads=BULK_THREADS,
                    smem_bytes=smem, blocks_per_sm=per_sm)


def copy_plan(g: WindowGeometry, n: int, rows: int, staged: bool, x_ptr: int, out_ptr: int,
              num_sms: int) -> CopyPlan:
    """The route and sizes of one ``window_copy`` launch of ``n`` windows of
    ``rows`` rows, from its geometry and base pointers alone.

    - ``staged``: a shared tile of up to TILE_BYTES holds whole pixels of a
      row; as few pixels as give the grid about four blocks per SM.
    - ``bulk``: whole pixels (one run per output row), every pointer, offset
      and stride a multiple of 16 bytes, and enough bytes that every block
      walks at least STAGES pieces of up to MAX_STAGE_BYTES of a row (on
      an H100, about 26 MB: the train path's frame gathers and segment
      expansion at the README configuration). The units are the widest of
      128, 64, 32 or 16 bytes that the pointers, offsets and strides allow;
      as many blocks per SM as the ring's shared memory lets reside, up to
      MAX_BULK_BLOCKS_PER_SM.
    - ``vector``: everything else, with the widest vector that divides it all.
    """
    out_rows = n * rows
    if out_rows < 1:
        raise ValueError(f"no rows to copy: {n} windows of {rows} rows")
    vec = vector_bytes(x_ptr, out_ptr, *g.byte_quantities(staged))
    if staged:
        if g.pix_bytes > TILE_BYTES:
            raise ValueError(f"staged needs a pixel of at most {TILE_BYTES} bytes, got "
                             f"{g.pix_bytes} (a whole-row copy is one pixel)")
        want_bpr = -(-4 * num_sms // out_rows)
        tile_pix = max(1, min(TILE_BYTES // g.pix_bytes, -(-g.W // want_bpr)))
        bpr = -(-g.W // tile_pix)
        plan = CopyPlan("staged", vec, blocks_per_row=bpr, tile_pix=tile_pix,
                        grid=out_rows * bpr)
    else:
        plan = _bulk_plan(g, out_rows, x_ptr, out_ptr, num_sms)
        if plan is None:
            bpr = -(-(g.cols * g.chs_bytes // vec) // (THREADS * UNROLL))
            plan = CopyPlan("vector", vec, blocks_per_row=bpr, grid=out_rows * bpr)
    if plan.grid > 0x7FFFFFFF:
        raise ValueError(f"{plan.grid} blocks do not fit one launch's grid")
    return plan


@functools.lru_cache(maxsize=256)
def _plan_array(g: WindowGeometry, n: int, rows: int, staged: bool, x_align: int,
                out_align: int, num_sms: int) -> Tuple[CopyPlan, np.ndarray]:
    """``copy_plan`` and the int64s the C entry point reads, kept per
    geometry, pointer alignment (mod 128) and card: a train step asks for
    the same few launches every time."""
    plan = copy_plan(g, n, rows, staged, x_align, out_align, num_sms)
    return plan, plan.as_array()


@dataclasses.dataclass(frozen=True)
class RepeatPlan:
    """``repeat_rows``' launch and every size the C entry point checks:
    ``grid`` = R * ``chunks_per_row`` blocks of THREADS; block ``r *
    chunks_per_row + c`` loads piece ``c`` (THREADS * ``unroll`` vectors of
    ``vec`` bytes) of row ``r`` once and stores it into the row's k copies."""

    vec: int
    unroll: int
    chunks_per_row: int
    grid: int
    threads: int = THREADS
    route = "vector"  # the vector body: repeat_rows has one route

    def as_array(self) -> np.ndarray:
        return np.array([getattr(self, f) for f in REPEAT_PLAN_FIELDS], dtype=np.int64)


def repeat_plan(R: int, row_bytes: int, k: int, x_ptr: int, out_ptr: int,
                num_sms: int) -> RepeatPlan:
    """The sizes of one ``repeat_rows`` launch of ``R`` rows of ``row_bytes``
    bytes repeated ``k`` times, from its geometry and base pointers alone:
    the widest vector that divides both pointers and the row, and the widest
    unroll of REPEAT_UNROLLS whose grid still holds a block for three SMs
    in four (else 1, the most blocks). On an H100 about one block per SM,
    each thread's loads all in flight, measured fastest: a grid of many more
    blocks (one per piece and copy) and one of fewer both measured slower
    (PERF.md). Raises ``ValueError`` where no launch fits the grid."""
    if R < 1 or row_bytes < 1 or k < 1:
        raise ValueError(f"no rows to repeat: {R} rows of {row_bytes} bytes, k = {k}")
    vec = vector_bytes(x_ptr, out_ptr, row_bytes)
    units = row_bytes // vec
    for unroll in REPEAT_UNROLLS:
        cpr = -(-units // (THREADS * unroll))
        if 4 * R * cpr >= 3 * num_sms:
            break
    grid = R * cpr
    if grid > 0x7FFFFFFF:
        raise ValueError(f"{grid} blocks do not fit one launch's grid")
    return RepeatPlan(vec, unroll, cpr, grid)


@functools.lru_cache(maxsize=256)
def _repeat_plan_array(R: int, row_bytes: int, k: int, x_align: int, out_align: int,
                       num_sms: int) -> Tuple[RepeatPlan, np.ndarray]:
    """``repeat_plan`` and the int64s the C entry point reads, kept per
    geometry, pointer alignment (mod 128) and card: a train step asks for
    the same launch every time."""
    plan = repeat_plan(R, row_bytes, k, x_align, out_align, num_sms)
    return plan, plan.as_array()


# the plan of the last window_copy or repeat_rows launch
LAST_PLAN: Optional[Union[CopyPlan, RepeatPlan]] = None


def _check_starts_tensor(x: torch.Tensor, starts: torch.Tensor) -> None:
    if starts.dim() != 1 or starts.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"starts must be a 1-D int32 or int64 tensor, got {starts.dtype} "
                         f"{tuple(starts.shape)}")
    if starts.device != x.device or not starts.is_contiguous():
        raise ValueError("starts must be contiguous and on the source's device")


def _check_out(out: torch.Tensor, shape, x: torch.Tensor) -> torch.Tensor:
    if (tuple(out.shape) != tuple(shape) or out.dtype != x.dtype or out.device != x.device
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {x.dtype} tensor of shape {tuple(shape)} "
                         f"on {x.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    return out


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {err}")


# ---------------------------------------------------------------- wrappers


def window_copy(x: torch.Tensor, starts: torch.Tensor, rows: int, col0: int = 0,
                cols: Optional[int] = None, ch0: int = 0, chs: Optional[int] = None,
                staged: bool = False, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel ``window_copy``: ``x`` (R, ..., W, C), ``starts`` (n,) int32 or
    int64 on ``x``'s device -> (n, rows, ..., cols, chs) with
    ``out[i, t] = x[starts[i] + t, ..., col0:col0 + cols, ch0:ch0 + chs]``.
    ``staged`` slices a shared-memory copy of each row instead of the global
    load (a pixel must fit the 32 KB tile). ``out``, where given, is written
    and returned: a contiguous tensor of that shape and ``x``'s dtype on its
    device (a slice of a larger buffer). On the card the starts are not read
    back: the caller has checked them (``check_starts``)."""
    _check_starts_tensor(x, starts)
    if x.device.type == "cpu":
        check_starts(starts, rows, x.shape[0])
        got = window_copy_plain(x, starts, rows, col0, cols, ch0, chs)
        return got if out is None else _check_out(out, got.shape, x).copy_(got)
    global LAST_PLAN
    check_kernel_input(x)
    n = starts.shape[0]
    g = window_geometry(tuple(x.shape), x.element_size(), n, rows, col0, cols, ch0, chs)
    if out is None:
        out = torch.empty(g.out_shape, dtype=x.dtype, device=x.device)
    else:
        _check_out(out, g.out_shape, x)
    if out.numel() == 0:
        return out
    plan, arr = _plan_array(g, n, rows, staged, x.data_ptr() % 128, out.data_ptr() % 128,
                            cuda_build.num_sms(x.device))
    with torch.cuda.device(x.device):
        err = _lib().window_copy(
            x.data_ptr(), starts.data_ptr(), int(starts.dtype == torch.int64), out.data_ptr(),
            n, rows, g.W, g.pix_bytes, g.col0, g.cols, g.ch0_bytes, g.chs_bytes,
            arr.ctypes.data, _stream(x),
        )
    _raise_on(err, "window_copy")
    profiling.count("launch.window_copy")
    LAST_PLAN = plan
    return out


def repeat_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel ``repeat_rows``: (R, ...) -> (R * k, ...), each row ``k`` times
    in a row."""
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    if x.device.type == "cpu":
        return repeat_rows_plain(x, k)
    global LAST_PLAN
    check_kernel_input(x)
    out = torch.empty((x.shape[0] * k,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    R = x.shape[0]
    row_bytes = x.numel() // R * x.element_size()
    plan, arr = _repeat_plan_array(R, row_bytes, k, x.data_ptr() % 128, out.data_ptr() % 128,
                                   cuda_build.num_sms(x.device))
    with torch.cuda.device(x.device):
        err = _lib().repeat_rows(x.data_ptr(), out.data_ptr(), R, row_bytes, k, arr.ctypes.data,
                                 _stream(x))
    _raise_on(err, "repeat_rows")
    profiling.count("launch.repeat_rows")
    LAST_PLAN = plan
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
    profiling.count("launch.roll_cols")
    return out
