"""What the 3x3 conv kernels of ``tracknetv3_tpu_torch/csrc/conv3x3.cu`` do
that the card alone can run, rehearsed on the CPU.

- ``launch_plan`` (sizes, grid, shared memory, the three tensor maps) at
  every conv shape of the serving forward at batch 16, at the odd shape and
  at the ablation probe's shape: shared memory within the H100's 232,448
  bytes and equal to what the source's ``static_assert`` lines state, every
  global stride a multiple of 16 bytes, every box within TMA's limits, and
  the grid covering every output pixel and channel exactly once; the plan's
  field order against the source's ``enum Plan``.
- A numpy model of the hardware: TMA's 128-byte swizzle (16-byte chunk q of
  a 128-byte row r at q ^ (r % 8), base 1024-aligned) on load and store,
  wgmma's descriptor reads (K-major A, MN-major B), ``ldmatrix``'s lane
  addresses and the accumulator fragment layout. Through it go the index
  formulas the kernels use (mirrored here line for line: ``sw128``, the
  sheet build, the descriptors' start offsets, the 9tap lane addresses, the
  epilogue's staging offsets), and for each tap the (pixel, channel) a
  product reads must be ``x[h + dy - 1, w + dx - 1, c]``, zero outside the
  image and past the last channel; the weights ``wp[dy, dx, c, co]``; each
  accumulator must land on its own output element.

Nothing here runs JAX: the function itself is held to the JAX package in
``tests/test_torch_conv3x3.py``.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tracknetv3_tpu_torch.ops import conv3x3 as c3  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tracknetv3_tpu_torch", "csrc", "conv3x3.cu")

# (H, W, Ci, Co) of the serving forward's 17 convs (chip_smoke.CONV_SHAPES),
# the first layer's 27 channels padded to the kernels' multiple
SERVE_SHAPES = [(288, 512, 32, 64), (288, 512, 64, 64), (288, 512, 192, 64),
                (144, 256, 64, 128), (144, 256, 128, 128), (144, 256, 384, 128),
                (72, 128, 128, 256), (72, 128, 256, 256), (72, 128, 768, 256),
                (36, 64, 256, 512), (36, 64, 512, 512)]
SHAPES = {f"serve_{h}x{w}_{ci}to{co}": (16, h, w, ci, co) for h, w, ci, co in SERVE_SHAPES}
SHAPES["odd_37x61_96to128"] = (3, 37, 61, 96, 128)
SHAPES["ablation_72x128_256to256"] = (24, 72, 128, 256, 256)
HC = c3.TW + 2


def _source() -> str:
    with open(SOURCE) as f:
        return f.read()


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("variant", c3.VARIANTS)
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_launch_plan_fits_and_covers_every_output_once(name, variant):
    N, H, W, Ci, Co = SHAPES[name]
    p = c3.launch_plan(N, H, W, Ci, Co, variant)
    assert p.BN == (128 if Co % 128 == 0 else 64)
    assert p.smem_bytes <= c3.SMEM_LIMIT
    for m in (p.x_map, p.w_map, p.y_map):
        assert all(s % 16 == 0 and s < 2 ** 40 for s in m.strides)
        assert all(1 <= b <= 256 for b in m.box) and m.box[0] * 2 <= 128  # SWIZZLE_128B
        assert len(m.strides) == len(m.dims) - 1
    assert p.x_map.dims == (Ci, W, H, N) and p.y_map.dims == (Co, W, H, N)
    assert p.w_map.dims == (Co, Ci, 9)
    assert p.MW == (2 if variant == "9tap" and Co == 64 else 1)
    assert p.x_map.box[2] == 8 * p.MW + 2 and p.y_map.box == (64, c3.TW, 4, 1)
    # the kernel's block decode; each m64 block's store box, clipped at H, W
    tiles_w, tiles_h = p.tiles
    cover = np.zeros((N, H, W, Co // 64), np.int32)
    for bx in range(p.grid[0]):
        w0, rest = (bx % tiles_w) * c3.TW, bx // tiles_w
        h0, n = (rest % tiles_h) * 8 * p.MW, rest // tiles_h
        for by in range(p.grid[1]):
            cb = by * p.BN // 64
            for wg in range(2):
                for mb in range(p.MW):
                    h = h0 + wg * 4 * p.MW + 4 * mb
                    if h < H:  # the kernel stores no box that lies wholly past H
                        cover[n, h:h + 4, w0:w0 + c3.TW, cb:cb + p.BN // 64] += 1
    assert cover.min() == 1 and cover.max() == 1


@pytest.mark.parametrize("variant,bn,stated", [("k3c", 128, 220288), ("9tap", 128, 228480),
                                               ("k3c", 64, 171136), ("9tap", 64, 191616)])
def test_plan_shared_memory_is_the_sources(variant, bn, stated):
    """The plan's bytes equal the kernels' (checked by a static_assert in the
    source, which a launch whose plan differs refuses)."""
    p = c3.launch_plan(1, 8, 16, 64, bn, variant)
    k3c = "true" if variant == "k3c" else "false"
    asserted = re.findall(rf"smem_bytes<{k3c}, {bn}, {p.MW}>\(\) == (\d+)", _source())
    assert [int(v) for v in asserted] == [stated]
    assert p.smem_bytes == stated
    s = p.stage_bytes
    assert s["weight_stage"] == bn // 64 * 3 * 64 * 128
    assert s["halo_tile"] == (8 * p.MW + 2) * 18 * 128
    assert s["halo_buffer"] % 1024 == 0 and s["per_warpgroup"] % 1024 == 0


def test_plan_order_is_the_sources_enum():
    src = _source()
    body = src[src.index("enum Plan"):src.index("};", src.index("enum Plan"))]
    enum = dict(re.findall(r"\b(P_[A-Z_]+) = (\d+)", body))
    p = c3.launch_plan(2, 9, 17, 24, 64, "k3c")
    arr = p.to_int64()
    assert len(arr) == int(enum["P_LEN"])
    offsets, i = {}, 0
    for field in c3.PLAN_FIELDS:
        offsets[field] = i
        mapped = field[:2] in ("x_", "w_", "y_")
        i += len(getattr(getattr(p, field[0] + "_map"), field[2:])) if mapped else 1
    for name in ("x_dims", "x_strides", "x_box", "w_dims", "w_strides", "w_box", "y_dims",
                 "y_strides", "y_box"):
        assert offsets[name] == int(enum[f"P_{name.upper()}"]), name
    assert list(arr[:11]) == [2, 9, 17, 24, 64, 64, 2 * 2 * 2, 1, p.smem_bytes, 2, 2]
    assert tuple(arr[offsets["x_box"]:offsets["x_box"] + 4]) == (64, 18, 10, 1)


@pytest.mark.parametrize("args,match", [
    ((1, 8, 16, 27, 64, "k3c"), "multiple of 8"),
    ((1, 8, 16, 32, 96, "9tap"), "multiple of 64"),
    ((1, 8, 16, 32, 64, "mm-only"), "128 output channels"),
    ((1, 8, 16, 32, 64, "winograd"), "unknown conv variant"),
])
def test_plan_refuses_what_the_kernels_do_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        c3.launch_plan(*args)


# ------------------------------------------------------------ the model

def sw128(row, q):
    """conv3x3.cu ``sw128``: byte offset of 16-byte chunk q of 128-byte row
    ``row`` in a 128B-swizzled buffer."""
    return row * 128 + ((q ^ (row & 7)) << 4)


def hw_swizzle(addr):
    """Where the hardware puts byte address ``addr`` of a 128B-swizzled
    region whose swizzle atoms start 1024-aligned (TMA and wgmma alike)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box(src_nhwc, origin, box):
    """(element offset in shared memory, value) of a TMA load of ``box`` =
    (b0 innermost, ...) at ``origin`` from a tensor whose numpy axes are the
    map's dims reversed; zero outside it."""
    idx = np.indices(box[::-1]).reshape(len(box), -1)[::-1]  # innermost first
    linear = np.zeros(idx.shape[1], np.int64)
    for d in range(len(box) - 1, -1, -1):
        linear = linear * box[d] + idx[d]
    coords = idx + np.asarray(origin)[:, None]
    shape = src_nhwc.shape[::-1]
    inside = np.all((coords >= 0) & (coords < np.asarray(shape)[:, None]), axis=0)
    vals = np.zeros(idx.shape[1])
    c = coords[:, inside]
    vals[inside] = src_nhwc[tuple(c[::-1])]
    return hw_swizzle(2 * linear) // 2, vals, coords, inside


def _problem(seed=0, N=2, H=11, W=19, Ci=72, Co=128):
    """Distinct values everywhere, so a read from the wrong place shows."""
    rng = np.random.default_rng(seed)
    x = rng.permutation(N * H * W * Ci).reshape(N, H, W, Ci).astype(np.float64) + 1
    wp = rng.permutation(9 * Ci * Co).reshape(9, Ci, Co).astype(np.float64) + 1
    return x, wp


def _halo(x, n, h0, w0, c0, mw=1):
    """Shared memory holding the halo tile of chunk c0 after its TMA load."""
    hr = 8 * mw + 2
    smem = np.full(hr * HC * 64, np.nan)
    off, vals, _, _ = tma_box(x, (c0, w0 - 1, h0 - 1, n), (c3.CK, HC, hr, 1))
    smem[off] = vals
    return smem


def _want_a(x, n, h0, w0, c0, row0, dy, dx, kk):
    """A[m, k] of the product for tap (dy, dx), K step kk, of the m64 block
    whose first row is tile row ``row0``: x at the output pixel's neighbour,
    zero outside the image and past Ci."""
    N, H, W, C = x.shape
    want = np.zeros((64, 16))
    for m in range(64):
        h, w = h0 + row0 + m // 16 + dy - 1, w0 + m % 16 + dx - 1
        for k in range(16):
            c = c0 + 16 * kk + k
            if 0 <= h < H and 0 <= w < W and c < C:
                want[m, k] = x[n, h, w, c]
    return want


# blocks (n, tile row, tile column, chunk): a corner, an inner tile, the ragged
# bottom-right one, each on the full first chunk and the partial second
BLOCKS = [(0, 0, 0, 0), (1, 0, 1, 64), (1, 1, 0, 0), (0, 1, 1, 64)]


@pytest.mark.parametrize("block", BLOCKS)
def test_k3c_sheet_and_descriptor_read_each_taps_neighbour(block):
    x, _ = _problem()
    n, th, tw, c0 = block
    h0, w0 = th * c3.TH, tw * c3.TW
    halo = _halo(x, n, h0, w0, c0)
    for wg in range(2):
        # the sheet build, as the consumer threads run it
        sheet = np.full(c3.SHEET_BYTES // 2, np.nan)
        rows = (4 + 2) * c3.TW
        for i in range(3 * rows * 8):
            q, r, dx = i & 7, (i >> 3) % rows, (i >> 3) // rows
            hp = (wg * 4 + r // c3.TW) * HC + r % c3.TW + dx
            dst = (dx * rows * 128 + sw128(r, q)) // 2
            sheet[dst:dst + 8] = halo[sw128(hp, q) // 2:sw128(hp, q) // 2 + 8]
        for dy in range(3):
            for dx in range(3):
                for kk in range(c3.CK // 16):
                    start = dx * rows * 128 + dy * c3.TW * 128 + kk * 32  # the A descriptor
                    assert (start - kk * 32) % 1024 == 0  # atom-aligned
                    m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
                    addr = start + (m // 8) * 1024 + (m % 8) * 128 + 2 * k  # SBO 1024
                    got = sheet[hw_swizzle(addr) // 2]
                    np.testing.assert_array_equal(got, _want_a(x, n, h0, w0, c0, 4 * wg, dy, dx,
                                                               kk))


@pytest.mark.parametrize("mw", [1, 2])
@pytest.mark.parametrize("block", BLOCKS)
def test_9tap_ldmatrix_lanes_read_each_taps_neighbour(block, mw):
    x, _ = _problem(H=8 * mw + 3)  # the second tile row ragged
    n, th, tw, c0 = block
    h0, w0 = th * 8 * mw, tw * c3.TW
    halo = _halo(x, n, h0, w0, c0, mw)
    lanes = np.arange(32)
    for wg, mb in ((wg, mb) for wg in range(2) for mb in range(mw)):
        for dy in range(3):
            for dx in range(3):
                for kk in range(c3.CK // 16):
                    got = np.full((64, 16), np.nan)
                    for wq in range(4):
                        hp = (wg * 4 * mw + wq + dy) * HC + (lanes & 15)
                        addr = sw128(hp + 4 * mb * HC + dx, 2 * kk + (lanes >> 4))  # lane l's row
                        # ldmatrix .x4: matrix i from lanes 8i..8i+7; thread t gets
                        # row t // 4, elements 2 (t % 4) and + 1 of each
                        frag = np.empty((32, 4, 2))
                        for t in range(32):
                            for i in range(4):
                                a = addr[8 * i + t // 4] // 2 + 2 * (t % 4)
                                frag[t, i] = halo[a:a + 2]
                        # the RS A fragment: regs 0-3 = (g, 2c), (g + 8, 2c), (g, 2c + 8),
                        # (g + 8, 2c + 8), two elements each
                        for t in range(32):
                            g, cc = t // 4, 2 * (t % 4)
                            for i, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                                got[16 * wq + g + dr, cc + dk:cc + dk + 2] = frag[t, i]
                    np.testing.assert_array_equal(
                        got, _want_a(x, n, h0, w0, c0, wg * 4 * mw + 4 * mb, dy, dx, kk))


@pytest.mark.parametrize("bn", [128, 64])
@pytest.mark.parametrize("co0,c0", [(0, 0), (128, 64)])
def test_weight_stage_descriptor_reads_each_taps_rows(co0, c0, bn):
    _, wp = _problem(Co=256)
    Ci = wp.shape[1]
    assert c3.launch_plan(2, 8, 32, Ci, bn, "9tap").w_map.box == (64, c3.CK, 3)
    for dy in range(3):
        # the producer's loads: one box (64, CK, 3) per 64-channel block
        stage = np.full(bn // 64 * c3.W_BLOCK_BYTES // 2, np.nan)
        for nb in range(bn // 64):
            off, vals, _, _ = tma_box(wp, (co0 + 64 * nb, c0, 3 * dy), (64, c3.CK, 3))
            stage[nb * c3.W_BLOCK_BYTES // 2 + off] = vals
        for dx in range(3):
            for kk in range(c3.CK // 16):
                start = dx * c3.CK * 128 + kk * 16 * 128  # the B descriptor
                k, nn = np.meshgrid(np.arange(16), np.arange(bn), indexing="ij")
                addr = (start + (nn // 64) * c3.W_BLOCK_BYTES + (k // 8) * 1024 + (k % 8) * 128
                        + 2 * (nn % 64))  # MN-major: LBO the 64-channel block, SBO 1024
                got = stage[hw_swizzle(addr) // 2]
                ci = c0 + 16 * kk + k
                want = np.where(ci < Ci, wp[3 * dy + dx, np.minimum(ci, Ci - 1), co0 + nn], 0.0)
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mw,bn", [(1, 128), (2, 64)])
@pytest.mark.parametrize("tile", [(0, 0), (1, 1)])
def test_epilogue_staging_and_store_put_each_accumulator_in_place(tile, mw, bn):
    """Each thread's accumulators (wgmma's m64nN fragment of m64 block mb:
    rows 16 wq + l / 4 (+ 8), columns 8 j + 2 (l % 4) (+ 1)) through the
    staging offsets and the TMA store box (64, 16, 4, 1), clipped at
    H = 8 MW + 3, W = 19."""
    N, H, W, Co, co0, n = 2, 8 * mw + 3, 19, 256, 128, 1
    h0, w0 = tile[0] * 8 * mw, tile[1] * c3.TW
    for wg, mb in ((wg, mb) for wg in range(2) for mb in range(mw)):
        nb_all = bn // 64
        staging = np.full(mw * nb_all * c3.STORE_BLOCK_BYTES // 2, np.nan)
        value = {}
        for wq in range(4):
            for lane in range(32):
                for j in range(bn // 8):
                    for half in range(2):
                        r = wq * 16 + (lane >> 2) + 8 * half
                        at = ((mb * nb_all + (j >> 3)) * c3.STORE_BLOCK_BYTES + sw128(r, j & 7)
                              + (lane & 3) * 4) // 2
                        for e in range(2):
                            col = 8 * j + 2 * (lane & 3) + e
                            staging[at + e] = value[r, col] = 1 + r * bn + col
        y = np.zeros((N, H, W, Co))
        row0 = wg * 4 * mw + 4 * mb
        for nb in range(nb_all):
            base = (mb * nb_all + nb) * c3.STORE_BLOCK_BYTES // 2
            off, _, coords, inside = tma_box(y, (co0 + 64 * nb, w0, h0 + row0, n),
                                             (64, c3.TW, 4, 1))
            cc = coords[:, inside]
            y[cc[3], cc[2], cc[1], cc[0]] = staging[base + off[inside]]
        for (r, col), v in value.items():
            h, w = h0 + row0 + r // 16, w0 + r % 16
            if h < H and w < W:
                assert y[n, h, w, co0 + col] == v
        assert np.count_nonzero(y) == sum(h0 + row0 + r // 16 < H and w0 + r % 16 < W
                                          for r, _ in value)
