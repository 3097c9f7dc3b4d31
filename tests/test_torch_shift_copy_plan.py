"""What ``window_copy``'s kernels in ``tracknetv3_tpu_torch/csrc/shift_copy.cu``
do that the card alone can run, rehearsed on the CPU.

``copy_plan`` chooses a launch's route from its geometry and computes every
size the launch passes in. Here, at every geometry ``chip_smoke.py``'s
``copy_vs_plain`` drives (the probes U1-U4 and U7 at their shapes; the
segment expansion, the resident, median and blend gathers at the README
configuration's), at a ragged last piece and at a 3-byte-pixel column shift:

- each case lands on the route it should (bulk for a copy of whole rows
  large enough to fill the ring, staged where asked, vector otherwise);
- a numpy model of the route's kernel, mirrored from the source (the bulk
  kernel's even shares of units, ``Cursor`` and ``Piece``; the vector kernel's
  block / thread / unroll units; the staged kernel's tile), writes every
  output byte exactly once, from the right source byte;
- every piece fits its ring stage, every block of the bulk route moves the
  same bytes to within one unit, every bulk copy is a multiple of 16 bytes
  at 16-byte aligned addresses, and the grid holds as many blocks per SM
  as the ring's shared memory lets reside (two at the largest stages);
- the plan's field order and the ring's constants agree with the source,
  and the ring's ``wait_group.read`` depth frees a stage before its refill.

Nothing here runs JAX: the copies themselves are held to the JAX package in
``tests/test_torch_shift_copy.py``.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tracknetv3_tpu_torch.ops import cuda_build  # noqa: E402
from tracknetv3_tpu_torch.ops import shift_copy as sc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tracknetv3_tpu_torch", "csrc", "shift_copy.cu")
SMS = 132  # the H100 SXM's SMs
SMEM_PER_SM = cuda_build.SMEM_PER_SM
FRAME = (288, 512, 3)  # the README configuration's uint8 frame
B, L, SEG_WINDOWS = 10, 8, 5

_rng = np.random.default_rng(0)


def _frame_case(n_src, starts, rows, elem=1):
    return dict(shape=(n_src,) + FRAME, elem=elem, starts=np.asarray(starts), rows=rows)


_span = SEG_WINDOWS + L - 1
# name: shape of x as the kernel sees it, element bytes, starts, rows, ranges,
# staged, the route it must take
CASES = {
    "U1": dict(shape=(32, 264, 128), elem=2, starts=np.arange(0, 32, 8), rows=8),
    "U2": dict(shape=(32, 264, 128), elem=2, starts=np.arange(0, 32, 8), rows=8, col0=1, cols=256),
    "U3": dict(shape=(32, 264, 128), elem=2, starts=np.arange(0, 32, 8), rows=8, col0=1, cols=256,
               staged=True),
    "U4": dict(shape=(32, 256, 256), elem=2, starts=np.arange(0, 32, 8), rows=8, ch0=128, chs=128,
               staged=True),
    "U4_direct": dict(shape=(32, 256, 256), elem=2, starts=np.arange(0, 32, 8), rows=8, ch0=128,
                      chs=128),
    "U7": dict(shape=(64, 264, 128), elem=2, starts=np.arange(0, 32, 8), rows=8, col0=1, cols=256),
    "segment_expand": _frame_case(
        2 * _span, (np.arange(2)[:, None] * _span + np.arange(SEG_WINDOWS)).reshape(-1), L),
    "resident_gather": _frame_case(160, _rng.integers(0, 160, B * L), 1),
    "resident_median_gather": _frame_case(4, _rng.integers(0, 4, B), 1, elem=4),
    "blend_gather_a": _frame_case(B * L, np.arange(B * L) // L * L + _rng.integers(0, L, B * L), 1),
    # rows of 24,592 bytes in 24 KB pieces: one full piece and a 16-byte one
    # (16-byte units: the row is off the 128-byte grid), 27 MB in all
    "ragged_last_chunk": dict(shape=(1200, 1537, 8), elem=2,
                              starts=_rng.integers(0, 1190, 100), rows=11),
    # a one-column shift of 3-byte uint8 pixels: no vector wider than a byte
    "pixel3_column_shift": dict(shape=(5, 40, 3), elem=1, starts=np.array([0, 2]), rows=3, col0=1,
                                cols=39),
}
# the route each case must take: the bulk route for the train path's large
# whole-frame copies and the large ragged case, the vector body for the
# probes' 2 MB copies, the 17.7 MB median gather, a channel range and a
# 3-byte pixel
ROUTES = {"U1": "vector", "U2": "vector", "U3": "staged", "U4": "staged",
          "U4_direct": "vector", "U7": "vector", "resident_median_gather": "vector",
          "pixel3_column_shift": "vector"}


def _geometry(c):
    n = len(c["starts"])
    g = sc.window_geometry(c["shape"], c["elem"], n, c["rows"], c.get("col0", 0), c.get("cols"),
                           c.get("ch0", 0), c.get("chs"))
    return g, n


def _plan(c, x_ptr=0, out_ptr=256):
    g, n = _geometry(c)
    return sc.copy_plan(g, n, c["rows"], c.get("staged", False), x_ptr, out_ptr, SMS), g, n


def _expected(xb, g, starts, rows):
    """out[i, t, w, cb] = x[starts[i] + t, col0 + w, ch0_bytes + cb] in bytes."""
    v = xb.reshape(-1, g.W, g.pix_bytes)
    idx = (starts[:, None] + np.arange(rows)[None, :]).reshape(-1)
    sel = v[idx][:, g.col0:g.col0 + g.cols, g.ch0_bytes:g.ch0_bytes + g.chs_bytes]
    return sel.reshape(-1)


# ------------------------------------------------------------ kernel models


def _bulk_model(xb, g, starts, rows, p):
    """window_copy_bulk_kernel, piece by piece: each block's share of the
    units, its cursor (one divide at its first unit, then steps; the next
    window's start read one window ahead), each piece's runs into its stage
    and its store."""
    n = len(starts)
    segs, seg_bytes, seg_stride, off0 = g.runs()
    contiguous = segs == 1
    src_unit_stride = p.unit_bytes if contiguous else seg_stride
    row_stride, out_row = g.W * g.pix_bytes, g.cols * g.chs_bytes
    out = np.zeros(n * rows * out_row, np.uint8)
    writes = np.zeros(out.size, np.int32)
    stage_use, block_bytes = [], []
    for b in range(p.grid):
        share = p.block_units(b)
        assert len(share) > 0, "a block without units"
        u, end = share.start, share.stop
        orow = u // p.units_per_row
        k = u - orow * p.units_per_row
        i, t = orow // rows, orow % rows
        start, next_start = starts[i], (starts[i + 1] if i + 1 < n else 0)
        moved = 0
        while u < end:  # Cursor::take
            m = min(p.chunk_units, p.units_per_row - k, end - u)
            src = (start + t) * row_stride + off0 + k * src_unit_stride
            dst = orow * out_row + k * p.unit_bytes
            if contiguous:
                runs = [(src, dst, m * p.unit_bytes)]
            else:
                runs = [(src + r * src_unit_stride, dst + r * p.unit_bytes, p.unit_bytes)
                        for r in range(m)]
            nbytes = sum(r[2] for r in runs)
            assert nbytes == m * p.unit_bytes <= p.stage_bytes
            stage_use.append(nbytes)
            moved += nbytes
            for s_off, d_off, nb in runs:
                assert s_off % 16 == 0 and nb % 16 == 0 and d_off % 16 == 0
                out[d_off:d_off + nb] = xb[s_off:s_off + nb]
                writes[d_off:d_off + nb] += 1
            u, k = u + m, k + m
            if k == p.units_per_row:
                k, orow, t = 0, orow + 1, t + 1
                if t == rows:
                    t, i = 0, i + 1
                    start = next_start
                    if i + 1 < n:
                        next_start = starts[i + 1]
        block_bytes.append(moved)
    # every block moves the same bytes to within one unit
    assert max(block_bytes) - min(block_bytes) <= p.unit_bytes
    return out, writes, stage_use


def _vector_model(xb, g, starts, rows, p):
    """window_copy_kernel<V, false>: block = (output row, chunk), thread u0 =
    chunk * THREADS * UNROLL + tid, its units u0 + j * THREADS."""
    V = p.vec
    segs, seg_bytes, seg_stride, off0 = g.runs()
    out_row = g.cols * g.chs_bytes
    units = out_row // V
    per_seg = seg_bytes // V
    chunk = np.arange(p.blocks_per_row)[:, None, None]
    tid = np.arange(sc.THREADS)[None, :, None]
    j = np.arange(sc.UNROLL)[None, None, :]
    u = (chunk * (sc.THREADS * sc.UNROLL) + tid + j * sc.THREADS).reshape(-1)
    u = u[u < units]
    s = np.zeros_like(u) if segs == 1 else u // per_seg
    src_unit = off0 + s * seg_stride + (u - s * per_seg) * V
    n = len(starts)
    out = np.zeros(n * rows * out_row, np.uint8)
    writes = np.zeros(out.size, np.int32)
    byte = np.arange(V)
    for orow in range(n * rows):
        i, t = divmod(orow, rows)
        src = (starts[i] + t) * g.W * g.pix_bytes
        d = (orow * out_row + u[:, None] * V + byte).reshape(-1)
        out[d] = xb[(src + src_unit[:, None] + byte).reshape(-1)]
        np.add.at(writes, d, 1)
    return out, writes


def _staged_model(xb, g, starts, rows, p):
    """window_copy_kernel<V, true>: block = (output row, chunk) holds pixels
    [p0, p0 + tile_pix) of the source row in its shared tile (the plan's
    tile, at most TILE_BYTES), and writes the columns and channel bytes of
    the range that fall in it."""
    V = p.vec
    tile_pix = p.tile_pix
    assert p.blocks_per_row == -(-g.W // tile_pix)
    out_row = g.cols * g.chs_bytes
    n = len(starts)
    out = np.zeros(n * rows * out_row, np.uint8)
    writes = np.zeros(out.size, np.int32)
    per_pix = g.chs_bytes // V
    byte = np.arange(V)
    for orow in range(n * rows):
        i, t = divmod(orow, rows)
        src = (starts[i] + t) * g.W * g.pix_bytes
        for chunk in range(p.blocks_per_row):
            p0 = chunk * tile_pix
            pn = min(g.W - p0, tile_pix)
            tile = xb[src + p0 * g.pix_bytes: src + (p0 + pn) * g.pix_bytes]
            assert tile.size <= sc.TILE_BYTES
            lo, hi = max(g.col0, p0), min(g.col0 + g.cols, p0 + pn)
            if hi <= lo:
                continue
            u = np.arange((hi - lo) * per_pix)
            px, k = u // per_pix, u % per_pix
            d = (orow * out_row + (lo - g.col0 + px[:, None]) * g.chs_bytes + k[:, None] * V
                 + byte).reshape(-1)
            s = ((lo - p0 + px[:, None]) * g.pix_bytes + g.ch0_bytes + k[:, None] * V
                 + byte).reshape(-1)
            out[d] = tile[s]
            np.add.at(writes, d, 1)
    return out, writes


# ------------------------------------------------------------ tests


@pytest.mark.parametrize("name", sorted(CASES))
def test_route_and_model_write_every_byte_once(name):
    c = CASES[name]
    p, g, n = _plan(c)
    assert p.route == ROUTES.get(name, "bulk")
    nbytes = int(np.prod(c["shape"])) * c["elem"]
    xb = np.random.default_rng(sorted(CASES).index(name)).integers(0, 256, nbytes, dtype=np.uint8)
    starts = c["starts"].astype(np.int64)
    if p.route == "bulk":
        out, writes, stage_use = _bulk_model(xb, g, starts, c["rows"], p)
        assert max(stage_use) <= p.stage_bytes <= sc.MAX_STAGE_BYTES
    elif p.route == "vector":
        out, writes = _vector_model(xb, g, starts, c["rows"], p)
    else:
        out, writes = _staged_model(xb, g, starts, c["rows"], p)
    assert (writes == 1).all(), f"bytes written {writes.min()}..{writes.max()} times"
    np.testing.assert_array_equal(out, _expected(xb, g, starts, c["rows"]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_fits_the_card(name):
    p, g, n = _plan(CASES[name])
    assert 1 <= p.grid <= 0x7FFFFFFF
    if p.route != "bulk":
        assert p.smem_bytes == 0 and p.threads == sc.THREADS
        assert p.grid == n * CASES[name]["rows"] * p.blocks_per_row
        if p.route == "staged":  # the tile fits, and the grid fills the card
            assert 1 <= p.tile_pix * g.pix_bytes <= sc.TILE_BYTES
            assert p.grid >= 2 * SMS
        return
    assert p.vec == 16 and p.threads == sc.BULK_THREADS
    assert p.stage_bytes % 128 == 0
    assert p.chunk_units * p.unit_bytes <= p.stage_bytes <= sc.MAX_STAGE_BYTES
    assert p.units_per_row * p.unit_bytes == g.cols * g.chs_bytes
    assert p.units == n * CASES[name]["rows"] * p.units_per_row
    assert p.smem_bytes == sc.BARRIER_BYTES + sc.STAGES * p.stage_bytes
    assert 1 <= p.blocks_per_sm <= sc.MAX_BULK_BLOCKS_PER_SM
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= SMEM_PER_SM
    if p.blocks_per_sm < sc.MAX_BULK_BLOCKS_PER_SM:  # as many as the shared memory lets in
        assert (p.blocks_per_sm + 1) * (p.smem_bytes + 1024) > SMEM_PER_SM
    assert p.grid == min(p.units, SMS * p.blocks_per_sm)
    # the ring fills: every block walks at least STAGES full pieces
    assert p.units >= p.grid * sc.STAGES * p.chunk_units
    assert p.chunk_units == min(p.units_per_row, sc.MAX_STAGE_BYTES // p.unit_bytes)
    # the widest unit the pointers (0, 256), offset and strides allow
    want = 16 if name == "ragged_last_chunk" else 128
    assert p.unit_bytes == want
    # every block has work, and the shares differ by at most one unit
    shares = [len(p.block_units(b)) for b in range(p.grid)]
    assert min(shares) >= 1 and max(shares) - min(shares) <= 1
    assert sum(shares) == p.units


def test_misaligned_pointer_or_stride_leaves_the_bulk_route():
    c = CASES["resident_gather"]
    assert _plan(c)[0].route == "bulk"
    p = _plan(c, x_ptr=8)[0]
    assert p.route == "vector" and p.vec == 8
    assert _plan(c, out_ptr=4)[0].vec == 4
    assert _plan(c, x_ptr=32)[0].unit_bytes == 32  # the units follow the pointers
    # a 2-byte column offset: runs start off the 16-byte grid
    odd = dict(c, shape=(160, 512, 3), elem=2, col0=1, cols=511)
    assert _plan(odd)[0].route == "vector"
    # the same copy with too few frames for the ring to fill
    assert _plan(dict(c, starts=c["starts"][:40]))[0].route == "vector"


def test_a_geometry_that_fits_no_route_raises():
    with pytest.raises(ValueError):  # staged: a pixel larger than the tile
        _plan(dict(shape=(4, 1, 40000), elem=1, starts=np.array([0]), rows=1, staged=True,
                   ch0=1, chs=10))
    with pytest.raises(ValueError):
        sc.copy_plan(_geometry(CASES["U1"])[0], 0, 8, False, 0, 0, SMS)


def test_constants_and_plan_fields_match_the_source():
    with open(SOURCE) as f:
        src = f.read()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kStages"] == sc.STAGES and consts["kLag"] == sc.LAG
    assert consts["kMaxStageBytes"] == sc.MAX_STAGE_BYTES
    assert consts["kBulkThreads"] == sc.BULK_THREADS
    assert consts["kMaxBulkBlocksPerSM"] == sc.MAX_BULK_BLOCKS_PER_SM
    assert consts["kBarrierBytes"] == sc.BARRIER_BYTES and consts["kTileBytes"] == sc.TILE_BYTES
    assert consts["kThreads"] == sc.THREADS and consts["kUnroll"] == sc.UNROLL
    enum = re.search(r"enum Plan \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names[-1] == "P_LEN"
    want = ["P_" + f.upper() for f in sc.PLAN_FIELDS]
    want[want.index("P_SMEM_BYTES")] = "P_SMEM"
    assert names[:-1] == want
    routes = re.search(r"enum Route \{([^}]*)\}", src).group(1)
    assert {k: int(v) for k, v in re.findall(r"kRoute(\w+) = (\d+)", routes)} == {
        k.capitalize(): v for k, v in sc.ROUTES.items()}
    # the ring: before the load of piece j (issued LAG pieces ahead of the
    # store), the stores issued are pieces <= j - LAG - 1; wait_group.read
    # N = STAGES - LAG - 1 leaves only the newest N pending, so the store of
    # piece j - STAGES, the stage's last user, has left shared memory
    n_pending = sc.STAGES - sc.LAG - 1
    assert f"wait_group_read<kStages - kLag - 1>" in src and n_pending >= 0
    for j in range(sc.STAGES, 4 * sc.STAGES):
        newest_done = (j - sc.LAG - 1) - n_pending
        assert newest_done >= j - sc.STAGES
