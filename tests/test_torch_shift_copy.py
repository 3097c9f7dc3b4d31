"""The port's copy ops (``ops/shift_copy.py``: ``window_copy``,
``repeat_rows``, ``roll_cols``) on the CPU, where each wrapper runs its plain
version, against the JAX package:

- the seven Pallas probes of ``tools/probe_mosaic_caps.py`` (U1-U7), run
  unedited in interpret mode. The probe prints which of its kernels equal
  their ``expect`` argument; the test rebuilds the probe's inputs from
  ``default_rng(0)`` in its draw order and holds the plain versions to the
  same expectations, bit for bit;
- the JAX train step's uses: ``gather_windows`` under ``vmap`` (segment
  expansion), ``jnp.repeat`` (the median), ``jnp.take`` (resident frames),
  ``take_along_axis`` (the blend's gathers), on uint8 frames at 32x64.

Copies keep bits: floats are compared as integer views, with NaN payloads,
-0.0 and inf among the inputs.
"""

import contextlib
import io
import json
import os
import runpy
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from tracknetv3_tpu.ops.preprocess import gather_windows as jax_gather_windows  # noqa: E402
from tracknetv3_tpu_torch.ops import shift_copy as sc  # noqa: E402
from tracknetv3_tpu_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, C, TH = 32, 256, 128, 8  # the probe's tile
PROBES = {
    "U1": "U1 leading-slice DMA",
    "U2": "U2 sublane-offset-1 DMA",
    "U3": "U3 in-kernel sublane-offset slice",
    "U4": "U4 in-kernel lane-slice aligned",
    "U5": "U5 pltpu.repeat sublane x2",
    "U6": "U6 f32 sublane roll",
    "U7": "U7 rank4 sublane-offset DMA",
}


@pytest.fixture(scope="module")
def probe_results():
    """The probe's own verdicts, its Pallas kernels in interpret mode."""
    real = pl.pallas_call

    def interpreted(*args, **kw):
        kw.setdefault("interpret", True)
        return real(*args, **kw)

    out = io.StringIO()
    with mock.patch.object(pl, "pallas_call", interpreted), contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(ROOT, "tools", "probe_mosaic_caps.py"), run_name="__main__")
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def probe_inputs():
    """The probe's inputs in its draw order (``probe_mosaic_caps.py:58-59``,
    ``:143-145``, ``:199``, ``:226-228``), as float32 numpy arrays holding the
    bfloat16-rounded values, and as torch tensors of the probe's dtypes."""
    rng = np.random.default_rng(0)

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    x = bf16(rng.standard_normal((H, W + 8, C), np.float32))
    x2 = bf16(rng.standard_normal((H, W, 256), np.float32))
    xf = rng.standard_normal((H, W, C), np.float32)
    x4 = bf16(rng.standard_normal((2, H, W + 8, C), np.float32))
    arrays = {"x": x, "x2": x2, "xf": xf, "x4": x4}
    arrays = {k: np.array(v) for k, v in arrays.items()}  # writable copies for torch
    tensors = {k: torch.from_numpy(v).to(torch.float32 if k == "xf" else torch.bfloat16)
               for k, v in arrays.items()}
    for k in ("x", "x2", "x4"):  # torch rounds to bfloat16 as JAX does
        np.testing.assert_array_equal(tensors[k].float().numpy(), arrays[k])
    return arrays, tensors


def _tile_starts():
    return torch.arange(0, H, TH, dtype=torch.int32)


def _port_probe(name, t):
    """The port's call for each probe, on the probe's row tiling."""
    s = _tile_starts()
    if name == "U1":
        return sc.window_copy(t["x"], s, TH).reshape(H, W + 8, C)
    if name in ("U2", "U3"):
        return sc.window_copy(t["x"], s, TH, col0=1, cols=W, staged=name == "U3").reshape(H, W, C)
    if name == "U4":
        return sc.window_copy(t["x2"], s, TH, ch0=128, chs=128, staged=True).reshape(H, W, 128)
    if name == "U5":
        return sc.repeat_rows(t["x"][:, :W].contiguous(), 2)
    if name == "U6":
        return sc.roll_cols(t["xf"], 1)
    if name == "U7":  # batch index 0 of the rank-4 input: a start offset of 0 * H
        return sc.window_copy(t["x4"].reshape(2 * H, W + 8, C), s + 0 * H, TH, col0=1,
                              cols=W).reshape(1, H, W, C)
    raise KeyError(name)


def _probe_expect(name, a):
    """Each probe's ``expect`` argument, from its source."""
    if name == "U1":
        return a["x"]
    if name in ("U2", "U3"):
        return a["x"][:, 1 : W + 1]
    if name == "U4":
        return a["x2"][:, :, 128:256]
    if name == "U5":
        xs = a["x"][:, :W]
        return np.concatenate([np.repeat(xs[i * TH : (i + 1) * TH], 2, 0) for i in range(H // TH)])
    if name == "U6":
        return np.roll(a["xf"], 1, 1)
    if name == "U7":
        return a["x4"][0:1, :, 1 : W + 1]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["U1", "U2", "U3", "U4", "U6", "U7"])
def test_plain_equals_probe_kernel(probe_results, probe_inputs, name):
    # the Pallas kernel equals the probe's expectation (its own verdict) ...
    assert probe_results[PROBES[name]] == "ok", probe_results
    # ... and so does the port's plain version, on the same inputs
    arrays, tensors = probe_inputs
    got = _port_probe(name, tensors)
    want = _probe_expect(name, arrays)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_u5_is_interleaved_not_tiled(probe_results, probe_inputs):
    """U5's expectation is ``np.repeat`` per row tile, which is the
    interleaved repeat of the whole array; ``pltpu.repeat`` concatenates
    copies, so in interpret mode the probe reports its own kernel wrong.
    The port computes the expectation."""
    arrays, tensors = probe_inputs
    status = probe_results[PROBES["U5"]]
    assert status in ("ok", "WRONG-VALUES"), status
    want = _probe_expect("U5", arrays)
    xs = arrays["x"][:, :W]
    np.testing.assert_array_equal(want, np.repeat(xs, 2, 0))
    got = _port_probe("U5", tensors)
    np.testing.assert_array_equal(got.float().numpy(), want)
    tiled = np.concatenate([np.tile(xs[i * TH : (i + 1) * TH], (2, 1, 1))
                            for i in range(H // TH)])
    assert not np.array_equal(tiled, want)
    if status == "WRONG-VALUES":
        # what the probe's kernel body computes on one row tile under this
        # JAX, interpreted: the tiled copy, not the expectation
        from jax.experimental.pallas import tpu as pltpu

        def body(x_ref, o_ref):
            o_ref[:] = pltpu.repeat(x_ref[:], 2, 0)

        interp = pl.pallas_call(
            body, out_shape=jax.ShapeDtypeStruct((2 * TH, W, C), jnp.bfloat16), interpret=True
        )(jnp.asarray(xs[:TH], jnp.bfloat16))
        interp = np.asarray(interp.astype(jnp.float32))
        np.testing.assert_array_equal(interp, tiled[: 2 * TH])
        assert not np.array_equal(interp, want[: 2 * TH])


# ------------------------------------------------------------ the path's uses

FRAME = (32, 64, 3)  # 6,144 bytes


def _frames(n, seed=0, shape=FRAME):
    return np.random.default_rng(seed).integers(0, 256, (n,) + shape, dtype=np.uint8)


@pytest.mark.parametrize("n_seg,seg,L", [(2, 2, 3), (1, 4, 3), (3, 5, 8)])
def test_segment_expansion_equals_gather_windows(n_seg, seg, L):
    span = seg + L - 1
    segs = _frames(n_seg * span, seed=n_seg).reshape((n_seg, span) + FRAME)
    want = jax.vmap(lambda f: jax_gather_windows(f, jnp.arange(seg), L))(jnp.asarray(segs))
    want = np.asarray(want).reshape((n_seg * seg, L) + FRAME)
    starts = (torch.arange(n_seg)[:, None] * span + torch.arange(seg)[None, :]).reshape(-1)
    got = sc.window_copy(torch.from_numpy(segs).reshape((n_seg * span,) + FRAME), starts, L)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_repeat_rows_equals_jnp_repeat(k):
    med = _frames(3, seed=k)
    want = np.asarray(jnp.repeat(jnp.asarray(med), k, axis=0))
    np.testing.assert_array_equal(sc.repeat_rows(torch.from_numpy(med), k).numpy(), want)
    if k > 1:  # a tiled repeat is another function
        assert not np.array_equal(np.tile(med, (k, 1, 1, 1)), want)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resident_gather_equals_jnp_take(dtype):
    buf = _frames(11, seed=4).astype(dtype)
    idx = np.random.default_rng(5).integers(0, 11, (4, 3)).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(buf), jnp.asarray(idx), axis=0))
    got = sc.window_copy(torch.from_numpy(buf), torch.from_numpy(idx).reshape(-1), 1)
    np.testing.assert_array_equal(got.reshape((4, 3) + FRAME).numpy(), want)


def test_blend_gathers_equal_take_along_axis():
    B, L = 4, 3
    frames = _frames(B * L, seed=6).reshape((B, L) + FRAME)
    pair = np.random.default_rng(7).integers(0, L, (B, L, 2)).astype(np.int32)
    for k in (0, 1):
        want = np.asarray(jnp.take_along_axis(
            jnp.asarray(frames), jnp.asarray(pair[..., k])[..., None, None, None], axis=1))
        starts = torch.arange(B)[:, None] * L + torch.from_numpy(pair[..., k]).long()
        got = sc.window_copy(torch.from_numpy(frames).reshape((B * L,) + FRAME),
                             starts.reshape(-1), 1)
        np.testing.assert_array_equal(got.reshape((B, L) + FRAME).numpy(), want)


@pytest.mark.parametrize("shift", [1, -1, 3, 64, 0])
def test_roll_cols_equals_np_roll(shift):
    x = np.random.default_rng(8).standard_normal((5, 64, 6)).astype(np.float32)
    np.testing.assert_array_equal(sc.roll_cols(torch.from_numpy(x), shift).numpy(),
                                  np.roll(x, shift, 1))


@pytest.mark.parametrize("dtype,bits", [(torch.bfloat16, torch.int16),
                                        (torch.float32, torch.int32)])
def test_copies_keep_every_bit(dtype, bits):
    """NaN payloads, -0.0, inf and denormals pass through as bits."""
    g = torch.Generator().manual_seed(1)
    words = torch.randint(-(2 ** 15), 2 ** 15, (6, 8, 4), generator=g)
    if bits == torch.int32:
        words = words * 65536 + torch.randint(0, 65536, (6, 8, 4), generator=g)
    special = {  # -0.0, +inf, two NaNs with different payloads
        torch.int16: (-32768, 0x7F80, 0x7FC1, -(0x8000 - 0x7F83)),
        torch.int32: (-(2 ** 31), 0x7F800000, 0x7FC00001, -(2 ** 31 - 0x7F800003)),
    }[bits]
    wb = words.to(bits)
    for i, v in enumerate(special):
        wb[i, 1, 1] = v
    x = wb.view(dtype)
    assert int(torch.isnan(x).sum()) >= 2 and bool(torch.isinf(x).any())
    s = torch.tensor([3, 0, 4], dtype=torch.int64)
    got = sc.window_copy(x, s, 2, col0=1, cols=5, ch0=1, chs=2)
    want = torch.stack([x[i : i + 2, 1:6, 1:3] for i in (3, 0, 4)])
    assert torch.equal(got.view(bits), want.view(bits))
    assert torch.equal(sc.repeat_rows(x, 3).view(bits),
                       x.view(bits).repeat_interleave(3, dim=0))
    assert torch.equal(sc.roll_cols(x, 1).view(bits), torch.roll(x.view(bits), 1, dims=-2))


# ------------------------------------------------------------ checks and geometry


def test_vector_bytes_is_the_widest_common_divisor():
    assert sc.vector_bytes(442368, 0, 1024) == 16
    assert sc.vector_bytes(256, 16 * 7, 32) == 16
    assert sc.vector_bytes(6144, 8) == 8
    assert sc.vector_bytes(64 * 3, 3) == 1  # a one-column shift of a 3-channel uint8 row
    assert sc.vector_bytes(64 * 6, 6) == 2
    assert sc.vector_bytes(12, 4) == 4
    assert sc.vector_bytes(0x7F0000000010, 0x7F0000000208, 32) == 8  # an odd base pointer


def test_window_geometry_folds_and_checks_ranges():
    # a whole-frame copy is one pixel of the frame's bytes
    g = sc.window_geometry((24, 288, 512, 3), 1, 10, 8, 0, None, 0, None)
    assert (g.W, g.pix_bytes, g.cols, g.chs_bytes) == (1, 442368, 1, 442368)
    assert g.out_shape == (10, 8, 288, 512, 3)
    assert sc.vector_bytes(*g.byte_quantities(False)) == 16
    # U2 at C = 128 bf16: a 256-byte shift
    g = sc.window_geometry((32, 264, 128), 2, 4, 8, 1, 256, 0, None)
    assert (g.W, g.pix_bytes, g.col0, g.cols, g.ch0_bytes, g.chs_bytes) == (264, 256, 1, 256, 0,
                                                                             256)
    assert g.out_shape == (4, 8, 256, 128)
    assert sc.vector_bytes(*g.byte_quantities(False)) == 16
    # U4: channels 128..255 of 256
    g = sc.window_geometry((32, 256, 256), 2, 4, 8, 0, None, 128, 128)
    assert (g.ch0_bytes, g.chs_bytes, g.pix_bytes) == (256, 256, 512)
    # an odd 3-channel uint8 box takes the scalar path
    g = sc.window_geometry((7, 63, 3), 1, 2, 2, 1, 61, 0, None)
    assert sc.vector_bytes(*g.byte_quantities(False)) == 1
    for bad in (dict(col0=1, cols=264), dict(ch0=1, chs=128), dict(rows=0), dict(col0=-1)):
        kw = dict(rows=8, col0=0, cols=None, ch0=0, chs=None)
        kw.update(bad)
        with pytest.raises(ValueError):
            sc.window_geometry((32, 264, 128), 2, 4, **kw)
    with pytest.raises(ValueError, match="3-D"):
        sc.window_geometry((4, 32, 64, 3), 1, 2, 1, 1, 10, 0, None)


def test_check_starts_refuses_windows_outside_the_source():
    sc.check_starts(np.array([0, 5, 9]), 3, 12)
    sc.check_starts(np.zeros(0, np.int64), 3, 12)
    for bad in ([10], [-1], [0, 12]):
        with pytest.raises(IndexError):
            sc.check_starts(np.array(bad), 3, 12)
    x = torch.zeros(12, 4, 2)
    with pytest.raises(IndexError):  # the CPU wrapper checks its starts itself
        sc.window_copy(x, torch.tensor([10]), 3)
    with pytest.raises(ValueError, match="int32 or int64"):
        sc.window_copy(x, torch.tensor([1.0]), 3)
    with pytest.raises(ValueError, match="1-D"):
        sc.window_copy(x, torch.tensor([[1]]), 3)


def test_kernel_input_checks():
    with pytest.raises(ValueError, match="CUDA"):
        sc.check_kernel_input(torch.zeros(4, 4, 4))
    with pytest.raises(ValueError, match="k >= 1"):
        sc.repeat_rows(torch.zeros(2, 3), 0)


def test_cpu_wrappers_count_no_launch():
    def launches():
        return {k: profiling.counters()[f"launch.{k}"] for k in sc.KERNELS}

    before = launches()
    x = torch.arange(24, dtype=torch.uint8).reshape(4, 3, 2)
    sc.window_copy(x, torch.tensor([0, 1]), 2)
    sc.repeat_rows(x, 2)
    sc.roll_cols(x, 1)
    assert launches() == before == {"window_copy": 0, "repeat_rows": 0, "roll_cols": 0}
