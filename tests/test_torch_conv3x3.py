"""The port's 3x3 conv with the folded forward's epilogue
(``tracknetv3_tpu_torch/ops/conv3x3.py``) vs the JAX package on the CPU.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
to ``conv3x3_bias_relu_plain``; here that plain version (which a CPU tensor
gets from the wrapper) is held to what the kernels replace:

- the Pallas probes in interpret mode, loaded from
  ``tools/probe_pallas_conv.py`` by path: ``make_conv3x3`` (P1) and
  ``make_conv3x3_wide`` with and without the sheet (P2) at the probe's own
  ``--interpret`` shapes, and ``jax.lax.conv_general_dilated``. The ablation
  probe (P3, ``tools/probe_pallas_ablate.py``) builds its kernels inside
  ``main()`` with no interpret switch; its two variants that compute a conv,
  ``full`` and ``full-9mm``, are P2's ``sheet=True`` / ``sheet=False`` line
  for line, so P2 stands for them;
- with the epilogue, the serving forward's ``_conv_relu`` at bfloat16 and
  float32.

Tolerance at bfloat16: ``BF16_ULPS`` = 1 bfloat16 spacing at the larger of
the two values, and not below the spacing at ``FLOOR_OF_RMS`` of the
output's RMS. Both sides round one float32 sum once; they add in different
orders, so they may land on neighbouring bfloat16 values, and an output
that cancels to far below the sums' size carries the sums' float32 error.
At float32: ``F32_TOL`` of the output's largest magnitude.

Inputs and weights come from numpy seeds.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.models import fused_forward as jff  # noqa: E402
from tracknetv3_tpu_torch.models import fused_forward as tff  # noqa: E402
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402
from tracknetv3_tpu_torch.ops import conv3x3 as c3  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULPS = 1.0
FLOOR_OF_RMS = 0.125
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_conv", os.path.join(ROOT, "tools", "probe_pallas_conv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_exact(a):
    """float32 numpy values rounded to bfloat16 (still float32)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _data(shape_nhwc, co, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    x = _bf16_exact(rng.standard_normal(shape_nhwc, np.float32))
    k = _bf16_exact(rng.standard_normal((3, 3, shape_nhwc[-1], co), np.float32) * scale)
    return x, k


def _port_input(x_nhwc, dtype):
    """NHWC numpy -> the wrapper's NCHW view of channels_last memory, channels
    padded as ``pack_weights`` pads the kernel's."""
    t = torch.from_numpy(x_nhwc)
    return tff._to_working_layout(t, dtype, c3.padded_channels(t.shape[-1]))


def _nhwc(y_nchw):
    return y_nchw.float().permute(0, 2, 3, 1)


def _assert_bf16_close(got, want):
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.shape == want.shape
    floor = FLOOR_OF_RMS * float(want.square().mean().sqrt())
    assert c3.bf16_ulps_apart(got, want, floor) <= BF16_ULPS


PROBE_CASES = {
    # the probe's --interpret shapes: (N, H, W, Ci), Co, TH
    "P1_24_to_64": ((2, 16, 128, 24), 64, 8, lambda p: p.make_conv3x3(8, interpret=True)),
    "P1_64_to_64": ((2, 8, 256, 64), 64, 8, lambda p: p.make_conv3x3(8, interpret=True)),
    "P2_sheet": ((2, 16, 128, 128), 128, 8,
                 lambda p: p.make_conv3x3_wide(8, interpret=True, sheet=True)),
    "P2_9mm": ((2, 16, 128, 128), 128, 8,
               lambda p: p.make_conv3x3_wide(8, interpret=True, sheet=False)),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_plain_bare_conv_matches_pallas_probe_and_lax(probe, case):
    shape, co, _, make = PROBE_CASES[case]
    x, k = _data(shape, co, seed=len(case))
    jx, jk = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    want_probe = make(probe)(jx, jk)
    want_lax = jax.lax.conv_general_dilated(
        jx, jk, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    assert want_probe.dtype == jnp.bfloat16
    packed = c3.pack_weights(k, torch.bfloat16, device="cpu")
    xt = _port_input(x, torch.bfloat16)
    for variant in c3.VARIANTS:  # a CPU tensor: the plain version, whatever the variant
        got = c3.conv3x3_bias_relu(xt, packed, None, variant=variant, relu=False)
        assert got.dtype == torch.bfloat16 and got.shape == (shape[0], co) + shape[1:3]
        assert got.is_contiguous(memory_format=torch.channels_last)
        _assert_bf16_close(_nhwc(got), want_probe.astype(jnp.float32))
        _assert_bf16_close(_nhwc(got), want_lax.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,co", [((2, 9, 21, 27), 64), ((1, 12, 16, 96), 128)])
def test_epilogue_matches_jax_conv_relu(dtype, shape, co):
    """Odd H and W, 27 channels padded to 32, biases large enough that the
    ReLU cuts about half the outputs and sums cancel against them."""
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
                "float32": (jnp.float32, torch.float32)}[dtype]
    x, k = _data(shape, co, seed=co)
    bias = np.random.default_rng(7).standard_normal(co).astype(np.float32)
    want = np.asarray(jff._conv_relu(jnp.asarray(x), k, bias, jdt).astype(jnp.float32))
    packed = c3.pack_weights(k, tdt, device="cpu")
    got = c3.conv3x3_bias_relu(_port_input(x, tdt), packed, torch.from_numpy(bias),
                               variant="k3c")
    assert got.dtype == tdt
    assert 0.2 < float((want == 0).mean()) < 0.8
    if dtype == "bfloat16":
        _assert_bf16_close(_nhwc(got), want)
    else:
        np.testing.assert_allclose(_nhwc(got).numpy(), want, rtol=0,
                                   atol=F32_TOL * float(np.abs(want).max()))


def test_relu_keeps_nan_as_jax_does():
    x, k = _data((1, 6, 8, 32), 64, seed=3)
    x[0, 2, 3, 5] = np.nan
    x[0, 4, 6, 1] = np.inf
    bias = np.zeros(64, np.float32)
    want = np.asarray(jff._conv_relu(jnp.asarray(x), k, bias, jnp.bfloat16).astype(jnp.float32))
    got = _nhwc(c3.conv3x3_bias_relu(_port_input(x, torch.bfloat16),
                                     c3.pack_weights(k, torch.bfloat16, device="cpu"),
                                     torch.from_numpy(bias), variant="9tap")).numpy()
    assert np.isnan(want).sum() == 9 * 64  # the NaN's 3x3 neighbourhood, every channel
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))


@pytest.mark.parametrize("ci,co", [(27, 64), (24, 64), (64, 128), (192, 64)])
def test_pack_weights_is_the_probes_reshape_with_zero_pad_rows(ci, co):
    k = np.random.default_rng(ci).standard_normal((3, 3, ci, co)).astype(np.float32)
    packed = c3.pack_weights(k, torch.float32, device="cpu")
    cp = c3.padded_channels(ci)
    assert cp % c3.CI_MULTIPLE == 0 and 0 <= cp - ci < c3.CI_MULTIPLE
    assert packed.shape == (3, 3 * cp, co) and packed.is_contiguous()
    rows = packed.reshape(3, 3, cp, co).numpy()
    np.testing.assert_array_equal(rows[:, :, :ci], k)
    assert not rows[:, :, ci:].any()
    if cp == ci:  # the probes' own layout: k.reshape(3, 3 * Ci, Co)
        np.testing.assert_array_equal(packed.numpy(), k.reshape(3, 3 * ci, co))
    assert c3.pack_weights(k, torch.bfloat16, device="cpu").dtype == torch.bfloat16


def _cl(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)


def _w(ci, co, dtype=torch.bfloat16):
    return torch.zeros((3, 3 * ci, co), dtype=dtype)


@pytest.mark.parametrize("x,packed,bias,match", [
    (lambda: _cl((1, 32, 5, 7)), lambda: _w(32, 64), lambda: torch.zeros(64), None),
    (lambda: _cl((1, 32, 5, 7)), lambda: _w(32, 64), lambda: None, None),
    (lambda: _cl((1, 32, 5, 7), torch.float32), lambda: _w(32, 64, torch.float32),
     lambda: None, "take bfloat16"),
    (lambda: torch.zeros((1, 32, 5, 7), dtype=torch.bfloat16), lambda: _w(32, 64),
     lambda: None, "channels_last"),
    (lambda: _cl((1, 27, 5, 7)), lambda: _w(27, 64), lambda: None, f"multiple of {c3.CI_MULTIPLE}"),
    (lambda: _cl((1, 32, 5, 7)), lambda: _w(32, 48), lambda: None, "multiple of 64"),
    (lambda: _cl((1, 27, 5, 7)), lambda: _w(32, 64), lambda: None, "pad the input"),
    (lambda: _cl((1, 32, 5, 7)), lambda: _w(32, 64, torch.float32), lambda: None,
     "weights are"),
    (lambda: _cl((1, 32, 5, 7)), lambda: _w(32, 64), lambda: torch.zeros(64).double(),
     "float32 bias"),
    (lambda: _cl((1, 32, 5, 7)), lambda: _w(32, 64), lambda: torch.zeros(32), "float32 bias"),
    (lambda: _cl((1, 32, 5, 7)), lambda: _w(32, 128)[:, :, ::2], lambda: None, "contiguous"),
    (lambda: _cl((1, 32, 5, 7)), lambda: torch.zeros(3 * 96 * 64 + 4,
                                                     dtype=torch.bfloat16)[4:].view(3, 96, 64),
     lambda: None, "16-byte aligned"),
    (lambda: torch.zeros((32, 5, 7), dtype=torch.bfloat16), lambda: _w(32, 64), lambda: None, r"\(N, C, H, W\)"),
])
def test_kernel_input_checks(x, packed, bias, match):
    """What the CUDA wrapper validates before it launches."""
    if match is None:
        c3.check_kernel_input(x(), packed(), bias())
    else:
        with pytest.raises(ValueError, match=match):
            c3.check_kernel_input(x(), packed(), bias())


def test_unknown_variant_and_backend_raise_and_cpu_counts_no_launch():
    before = dict(c3.LAUNCHES)
    x, packed = _cl((1, 32, 5, 7)), _w(32, 64)
    with pytest.raises(ValueError, match="unknown conv variant"):
        c3.conv3x3_bias_relu(x, packed, None, variant="cudnn")
    c3.conv3x3_bias_relu(x, packed, None, variant="k3c")
    assert c3.LAUNCHES == before
    with pytest.raises(ValueError, match="unknown conv_backend"):
        tff.fused_params({}, torch.bfloat16, "cpu", conv_backend="hand")
    with pytest.raises(ValueError, match=r"\(3, 3, Ci, Co\)"):
        c3.pack_weights(np.zeros((3, 27, 64), np.float32), torch.bfloat16, device="cpu")


def test_conv_backend_rule_defaults_by_dtype_and_refuses_float32_hand_on_the_card():
    """One rule for every caller (``fused_params``, the predictor, the CLIs):
    unset gives the bfloat16 default or cuDNN at float32; a hand backend at
    float32 runs its plain version on the CPU and raises on the card."""
    assert tff.resolve_conv_backend(None, torch.bfloat16, "cuda") == tff.DEFAULT_CONV_BACKEND
    assert tff.resolve_conv_backend(None, torch.float32, "cuda") == "cudnn"
    assert tff.resolve_conv_backend(None, torch.float32, "cpu") == "cudnn"
    for backend in ("hand_k3c", "hand_9tap"):
        assert tff.resolve_conv_backend(backend, torch.bfloat16, "cuda") == backend
        assert tff.resolve_conv_backend(backend, torch.float32, "cpu") == backend
        with pytest.raises(ValueError, match="bfloat16 conv kernels"):
            tff.resolve_conv_backend(backend, torch.float32, "cuda")
        with pytest.raises(ValueError, match="bfloat16 conv kernels"):
            tff.fused_params({}, torch.float32, torch.device("cuda"), conv_backend=backend)
    assert tff.resolve_conv_backend("cudnn", torch.float32, "cuda") == "cudnn"
    model = get_model("TrackNet", 8, "concat", generator=torch.Generator().manual_seed(5))
    params = tff.fused_params(tff.fold_batchnorm(model), torch.bfloat16, "cpu")
    assert params["conv_backend"] == tff.DEFAULT_CONV_BACKEND
