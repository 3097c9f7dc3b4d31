"""The port's serving forward and its pool / upsample kernels' plain versions
vs the JAX package on the CPU.

- ``fold_batchnorm`` from the JAX variables and from the port's TrackNet
  vs the JAX ``fold_batchnorm``: rtol 1e-6.
- ``tracknet_fused_forward`` vs the JAX one (the bounds of
  ``tests/test_fused_forward.py``): atol 1e-5 at float32, 5e-3 at
  bfloat16. And vs the port's unfolded TrackNet in eval mode: max |dp|
  1e-5 and mean 1e-6 at float32; at bfloat16, two roundings of one
  function (the folded kernels W' rounded to bfloat16, against W rounded
  and BatchNorm applied in float32 after the convolution), max 5e-3 and
  mean 1e-3, where this random init reads 1.1e-3 and 1.9e-4. Trained
  weights at 288x512 read up to 1.4e-2 on the card, so ``chip_smoke.py``
  holds the card to its own bfloat16 bound, set between those readings and
  those of deliberately wrong forwards.
- The same forward with the 3x3 convs on a hand backend
  (``conv_backend="hand_k3c"`` / ``"hand_9tap"``, on the CPU the plain
  version of ``ops/conv3x3.py``: the bias added to the float32 sum, one
  rounding) vs the JAX forward: atol 1e-5 at float32, and 2e-3 at
  bfloat16, tighter than the ``cudnn`` route's 5e-3 because each layer
  rounds once as JAX does (this init reads 8.0e-4 against 9.9e-4; what is
  left is the order of the sums and the predictor's rounding).
- The plain pool and upsample vs ``_pool`` / ``_up2x``: bit-exact, NaN
  and -inf included; on a CPU tensor the wrappers return the plain result.
  The CUDA kernels are held against the same plain versions on the card
  by ``chip_smoke.py``.

Weights come from a JAX random init with BatchNorm statistics drawn from a
numpy seed (so the fold is not the identity), inputs from numpy seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.models import fused_forward as jff  # noqa: E402
from tracknetv3_tpu.models import get_model as jax_get_model  # noqa: E402
from tracknetv3_tpu_torch.models import fused_forward as tff  # noqa: E402
from tracknetv3_tpu_torch.models.convert import BLOCKS, tracknet_from_jax  # noqa: E402
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402
from tracknetv3_tpu_torch.ops import conv3x3 as c3  # noqa: E402
from tracknetv3_tpu_torch.ops import pool_up2x as pu  # noqa: E402

SEQ, BG, N, HGT, WDT = 3, "concat", 2, 32, 64
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-3)}
HAND_TOL = {"float32": 1e-5, "bfloat16": 2e-3}  # the hand conv backends vs JAX
# (max, mean) |dp| of the folded vs the unfolded forward
UNFOLDED_BOUNDS = {"float32": (1e-5, 1e-6), "bfloat16": (5e-3, 1e-3)}


@pytest.fixture(scope="module")
def variables():
    _, v = jax_get_model("TrackNet", SEQ, BG, rng=jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.default_rng(0)
    for block in v["batch_stats"].values():
        for sub in block.values():
            bn = sub["bn"]
            bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    for block in v["params"].values():
        if "conv_1" in block:
            for sub in block.values():
                bn = sub["bn"]
                bn["scale"] = rng.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)
                bn["bias"] = rng.normal(0, 0.1, bn["bias"].shape).astype(np.float32)
    return v


def _port_model(v, dtype):
    model = get_model("TrackNet", SEQ, BG, dtype=dtype)
    model.load_state_dict(tracknet_from_jax(v))
    return model.eval()


def _x(seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (N, HGT, WDT, 12)).astype(np.float32)


def _assert_folded_equal(got, want):
    for block, n in BLOCKS:
        assert len(got[block]) == n
        for (gk, gb), (wk, wb) in zip(got[block], want[block]):
            np.testing.assert_allclose(gk, np.asarray(wk), rtol=1e-6, atol=0)
            np.testing.assert_allclose(gb, np.asarray(wb), rtol=1e-6, atol=1e-7)
    for g, w in zip(got["predictor"], want["predictor"]):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("source", ["jax_variables", "port_model", "port_state_dict"])
def test_fold_batchnorm_matches_jax(variables, source):
    want = jff.fold_batchnorm(variables)
    model = _port_model(variables, torch.float32)
    arg = {"jax_variables": variables, "port_model": model,
           "port_state_dict": model.state_dict()}[source]
    _assert_folded_equal(tff.fold_batchnorm(arg), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_forward_matches_jax(variables, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x = _x()
    want = np.asarray(jff.tracknet_fused_forward(jff.fold_batchnorm(variables),
                                                 jnp.asarray(x), dtype=jdt))
    params = tff.fused_params(tff.fold_batchnorm(variables), tdt, "cpu")
    got = tff.tracknet_fused_forward(params, torch.from_numpy(x))
    assert got.shape == (N, HGT, WDT, SEQ) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("backend", ["hand_k3c", "hand_9tap"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_forward_hand_backend_matches_jax(variables, dtype, backend):
    jdt, tdt, cudnn_tol = DTYPES[dtype]
    assert HAND_TOL[dtype] <= cudnn_tol
    x = _x()
    want = np.asarray(jff.tracknet_fused_forward(jff.fold_batchnorm(variables),
                                                 jnp.asarray(x), dtype=jdt))
    params = tff.fused_params(tff.fold_batchnorm(variables), tdt, "cpu", conv_backend=backend)
    assert params["conv_backend"] == backend
    w0, b0 = params["down_block_1"][0]
    cp = c3.padded_channels(12)  # 12 channels padded to the kernels' multiple
    assert cp % c3.CI_MULTIPLE == 0 and 0 <= cp - 12 < c3.CI_MULTIPLE
    assert w0.shape == (3, 3 * cp, 64) and b0.shape == (64,)
    got = tff.tracknet_fused_forward(params, torch.from_numpy(x))
    assert got.shape == (N, HGT, WDT, SEQ) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=HAND_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_forward_matches_unfolded_eval(variables, dtype):
    _, tdt, _ = DTYPES[dtype]
    max_bound, mean_bound = UNFOLDED_BOUNDS[dtype]
    x = _x(2)
    model = _port_model(variables, tdt)
    with torch.no_grad():
        ref = torch.sigmoid(model(torch.from_numpy(x).permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    params = tff.fused_params(tff.fold_batchnorm(model), tdt, "cpu")
    got = tff.tracknet_fused_forward(params, torch.from_numpy(x))
    d = (got - ref).abs()
    assert float(d.max()) <= max_bound and float(d.mean()) <= mean_bound, (d.max(), d.mean())


def test_fused_forward_logits(variables):
    x = _x(3)
    folded = jff.fold_batchnorm(variables)
    want = np.asarray(jff.tracknet_fused_forward(folded, jnp.asarray(x), dtype=jnp.float32,
                                                 apply_sigmoid=False))
    got = tff.tracknet_fused_forward(tff.fused_params(folded, torch.float32, "cpu"),
                                     torch.from_numpy(x), apply_sigmoid=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _special_values(shape, seed, dtype):
    """Random values with a few NaN, -inf and +inf entries, as NHWC numpy
    float32 (every value exact in bfloat16 when ``dtype`` is bfloat16)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    flat = a.reshape(-1)
    idx = rng.choice(flat.size, size=12, replace=False)
    flat[idx[:5]] = np.nan
    flat[idx[5:9]] = -np.inf
    flat[idx[9:]] = np.inf
    if dtype == torch.bfloat16:
        a = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return a


def _nchw(a_nhwc, dtype):
    return torch.from_numpy(a_nhwc).to(dtype).permute(0, 3, 1, 2)


def _assert_same(got_nchw, want_nhwc):
    got = got_nchw.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want_nhwc, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 8, 12, 16), (1, 4, 6, 64)])
def test_pool_matches_jax_bit_exact(dtype, shape):
    a = _special_values(shape, 5, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jff._pool(jnp.asarray(a, jdt))
    x = _nchw(a, dtype)
    _assert_same(pu.maxpool2x2_plain(x), want)
    _assert_same(pu.maxpool2x2(x.contiguous(memory_format=torch.channels_last)), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 3, 5, 16), (1, 4, 8, 24)])
def test_up2x_matches_jax_bit_exact(dtype, shape):
    a = _special_values(shape, 6, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jff._up2x(jnp.asarray(a, jdt))
    x = _nchw(a, dtype)
    _assert_same(pu.up2x_nearest_plain(x), want)
    _assert_same(pu.up2x_nearest(x.contiguous(memory_format=torch.channels_last)), want)


def test_up2x_interleaves_not_tiles():
    """The semantics the probe checks at tools/probe_bn_pool.py:257-266."""
    x = torch.arange(8, dtype=torch.float32).reshape(1, 2, 2, 2).permute(0, 3, 1, 2)
    got = pu.up2x_nearest(x).permute(0, 2, 3, 1)
    want = np.asarray(jff._up2x(jnp.arange(8, dtype=jnp.float32).reshape(1, 2, 2, 2)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, :, :, 0].tolist() == [[0, 0, 2, 2], [0, 0, 2, 2], [4, 4, 6, 6], [4, 4, 6, 6]]


def _cl(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("x,even,match", [
    (lambda: _cl((1, 8, 4, 4)), True, None),
    (lambda: _cl((1, 4, 4, 4), torch.float32), True, None),
    (lambda: _cl((1, 8, 4, 4), torch.float16), True, "bfloat16 or float32"),
    (lambda: torch.zeros((1, 8, 4, 4), dtype=torch.bfloat16), True, "channels_last"),
    (lambda: _cl((1, 4, 4, 4)), True, "16-byte"),
    (lambda: _cl((1, 8, 5, 4)), True, "even"),
    (lambda: _cl((1, 8, 5, 4)), False, None),
    (lambda: torch.zeros((8, 4, 4), dtype=torch.bfloat16), True, "4-D"),
])
def test_kernel_input_checks(x, even, match):
    """What the CUDA wrappers validate before they launch."""
    t = x()
    if match is None:
        pu.check_kernel_input(t, even_hw=even)
    else:
        with pytest.raises(ValueError, match=match):
            pu.check_kernel_input(t, even_hw=even)


def test_cpu_wrappers_do_not_count_launches():
    before = dict(pu.LAUNCHES)
    x = _cl((1, 8, 4, 4))
    pu.maxpool2x2(x)
    pu.up2x_nearest(x)
    assert pu.LAUNCHES == before
