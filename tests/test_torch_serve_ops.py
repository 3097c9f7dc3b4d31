"""The port's serving ops vs the JAX package's on the CPU.

- ``gather_windows``, ``background_diff`` and ``make_staged_preprocessor``
  (all four bg modes, with and without the BGR flip, float32 and bfloat16
  output): bit-exact.
- ``median_of_u8_stack`` for odd and even T and the staged sampling rule:
  bit-exact (``np.median`` too).
- ``ensemble_update_fn`` (with ``n_valid`` padding rows holding inf),
  ``ensemble_flush``, ``ensemble_chunk``: atol 1e-6.
- ``generate_inpaint_mask`` / ``linear_interp`` copies: equal.
- InpaintNet: the forward vs the flax module at atol 1e-6, the weight
  conversion round trip exact, and npz checkpoints of either package load
  in the other.

Inputs come from numpy seeds and go to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.models import get_model as jax_get_model  # noqa: E402
from tracknetv3_tpu.ops import ensemble as jens  # noqa: E402
from tracknetv3_tpu.ops import postprocess as jpost  # noqa: E402
from tracknetv3_tpu.ops import preprocess as jpre  # noqa: E402
from tracknetv3_tpu.training import checkpoint as jckpt  # noqa: E402
from tracknetv3_tpu_torch.inference import TrackNetPredictor  # noqa: E402
from tracknetv3_tpu_torch.models.convert import (  # noqa: E402
    inpaintnet_from_jax,
    inpaintnet_to_jax,
)
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402
from tracknetv3_tpu_torch.models.inpaintnet import InpaintNet  # noqa: E402
from tracknetv3_tpu_torch.ops import ensemble as tens  # noqa: E402
from tracknetv3_tpu_torch.ops import postprocess as tpost  # noqa: E402
from tracknetv3_tpu_torch.ops import preprocess as tpre  # noqa: E402
from tracknetv3_tpu_torch.training import checkpoint as tckpt  # noqa: E402

H, W, L = 32, 64, 3


def _frames(T, seed):
    return np.random.default_rng(seed).integers(0, 256, (T, H, W, 3), dtype=np.uint8)


# ---------------------------------------------------------------- preprocess


def test_gather_windows_clips_at_last_frame():
    buf = _frames(7, 0)
    starts = np.array([0, 3, 5, 6], np.int32)
    want = np.asarray(jpre.gather_windows(jnp.asarray(buf), jnp.asarray(starts), L))
    got = tpre.gather_windows(torch.from_numpy(buf), torch.from_numpy(starts).long(), L)
    np.testing.assert_array_equal(got.numpy(), want)


def test_background_diff_wraps_mod_256():
    frames = _frames(4, 1)
    median = np.random.default_rng(2).integers(0, 256, (H, W, 3)).astype(np.float32)
    median[::2] += 0.5  # an even-T median has half values
    want = np.asarray(jpre.background_diff(jnp.asarray(frames), jnp.asarray(median)))
    got = tpre.background_diff(torch.from_numpy(frames), torch.from_numpy(median))
    assert (want > 200).any() and (np.abs(frames.astype(np.float32) - median).sum(-1) > 255).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("T", [1, 2, 7, 10])
def test_median_of_u8_stack_exact(T):
    buf = _frames(T, 10 + T)
    want = np.asarray(jpre.median_of_u8_stack(jnp.asarray(buf)))
    got = tpre.median_of_u8_stack(torch.from_numpy(buf)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.median(buf.astype(np.float32), axis=0))


@pytest.mark.parametrize("max_sample_num", [None, 4, 5, 100])
def test_median_sampling_rule(max_sample_num):
    """The JAX package's rule (``inference.py:545-553``): all frames, or k
    frames at a stride of T // k."""
    from tracknetv3_tpu.inference import TrackNetPredictor as JaxPredictor

    buf = _frames(13, 3)
    want = np.asarray(JaxPredictor._median_staged_traced(jnp.asarray(buf), 13, max_sample_num))
    got = TrackNetPredictor._median_staged(torch.from_numpy(buf), max_sample_num)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bgr", [False, True])
@pytest.mark.parametrize("bg_mode", ["", "subtract", "subtract_concat", "concat"])
def test_staged_preprocessor_bit_exact(bg_mode, bgr, out_dtype):
    buf = _frames(9, 4)
    median = np.median(buf.astype(np.float32), axis=0)[..., ::-1].copy()  # x.5 values
    starts = np.array([0, 2, 5, 7, 8], np.int32)  # the last two run past the end
    jdt = None if out_dtype == "float32" else jnp.bfloat16
    want = jpre.make_staged_preprocessor(bg_mode, L, bgr, out_dtype=jdt)(
        jnp.asarray(buf), jnp.asarray(median), jnp.asarray(starts))
    tdt = None if out_dtype == "float32" else torch.bfloat16
    got = tpre.make_staged_preprocessor(bg_mode, L, bgr, out_dtype=tdt)(
        torch.from_numpy(buf), torch.from_numpy(median), torch.from_numpy(starts).long())
    assert got.dtype == (torch.float32 if tdt is None else tdt)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ---------------------------------------------------------------- ensemble


@pytest.mark.parametrize("mode", ["weight", "average"])
@pytest.mark.parametrize("seq_len", [3, 4, 8])
def test_ensemble_weight(mode, seq_len):
    np.testing.assert_array_equal(tens.get_ensemble_weight(seq_len, mode),
                                  jens.get_ensemble_weight(seq_len, mode))


def _windows(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, L, 5, 6)).astype(np.float32)


def test_ensemble_update_and_flush_match_jax():
    """Three chunks of B=4 over 10 real windows: full, full, then 2 real rows
    and 2 padding rows holding inf; then the flush."""
    B = 4
    weights = tens.get_ensemble_weight(L, "weight")
    wins = _windows(12, 5)
    wins[10:] = np.inf
    jstate = jens.ensemble_init(L, (5, 6))
    tstate = tens.ensemble_init(L, (5, 6))
    for k, nv in enumerate((4, 4, 2)):
        chunk = wins[k * B : (k + 1) * B]
        jstate, jf = jens.ensemble_update_fn(jstate, jnp.asarray(chunk), jnp.asarray(weights),
                                             jnp.int32(nv))
        tstate, tf = tens.ensemble_update_fn(tstate, torch.from_numpy(chunk),
                                             torch.from_numpy(weights), nv)
        np.testing.assert_allclose(tf[:nv].numpy(), np.asarray(jf)[:nv], atol=1e-6, rtol=0)
        assert np.isfinite(tf[:nv].numpy()).all()
        np.testing.assert_allclose(tstate.tail.numpy(), np.asarray(jstate.tail), atol=1e-6)
        assert tstate.next_frame == int(jstate.next_frame)
    np.testing.assert_allclose(tens.ensemble_flush(tstate).numpy(),
                               np.asarray(jens.ensemble_flush(jstate)), atol=1e-6, rtol=0)


def test_ensemble_flush_fewer_windows_than_tail():
    """One real window (a video shorter than L): the flush divides by S."""
    weights = tens.get_ensemble_weight(L, "average")
    wins = _windows(4, 6)
    jstate, _ = jens.ensemble_update_fn(jens.ensemble_init(L, (5, 6)), jnp.asarray(wins),
                                        jnp.asarray(weights), jnp.int32(1))
    tstate, _ = tens.ensemble_update_fn(tens.ensemble_init(L, (5, 6)), torch.from_numpy(wins),
                                        torch.from_numpy(weights), 1)
    np.testing.assert_allclose(tens.ensemble_flush(tstate).numpy(),
                               np.asarray(jens.ensemble_flush(jstate)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("t0,num_windows", [(0, 9), (4, 9), (8, 9), (0, 2)])
def test_ensemble_chunk_matches_jax(t0, num_windows):
    B = 4
    weights = tens.get_ensemble_weight(L, "weight")
    wins = _windows(B + L - 1, 7)
    w_global = t0 - (L - 1) + np.arange(B + L - 1)
    wins[(w_global < 0) | (w_global >= num_windows)] = np.inf  # arbitrary rows
    want = jens.ensemble_chunk(jnp.asarray(wins), jnp.asarray(weights), jnp.int32(t0),
                               jnp.int32(num_windows))
    got = tens.ensemble_chunk(torch.from_numpy(wins), torch.from_numpy(weights), t0,
                              num_windows)
    n_real = min(B, num_windows + L - 1 - t0)  # frames past S+L-2 are garbage
    np.testing.assert_allclose(got.numpy()[:n_real], np.asarray(want)[:n_real], atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------- postprocess


@pytest.mark.parametrize("seed", range(4))
def test_inpaint_mask_and_linear_interp_match_jax(seed):
    rng = np.random.default_rng(seed)
    vis = (rng.uniform(size=40) > 0.3).astype(int).tolist()
    y = rng.integers(0, 100, 40).tolist()
    pred = {"Visibility": vis, "Y": y}
    mask = tpost.generate_inpaint_mask(pred, th_h=20)
    assert mask == jpost.generate_inpaint_mask(pred, th_h=20)
    np.testing.assert_array_equal(tpost.linear_interp(y, mask), jpost.linear_interp(y, mask))


# ---------------------------------------------------------------- InpaintNet


@pytest.fixture(scope="module")
def inpaint_vars():
    _, v = jax_get_model("InpaintNet", 16, rng=jax.random.PRNGKey(2))
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.default_rng(8)
    for layer in v["params"].values():  # non-zero biases
        inner = layer.get("conv", layer)
        inner["bias"] = rng.normal(0, 0.1, inner["bias"].shape).astype(np.float32)
    return v


def test_inpaintnet_forward_matches_jax(inpaint_vars):
    from tracknetv3_tpu.models.inpaintnet import InpaintNet as JaxInpaintNet

    rng = np.random.default_rng(9)
    coords = rng.uniform(0, 1, (5, 16, 2)).astype(np.float32)
    mask = (rng.uniform(size=(5, 16, 1)) > 0.5).astype(np.float32)
    want = np.asarray(JaxInpaintNet().apply(inpaint_vars, coords, mask))
    model = get_model("InpaintNet")
    model.load_state_dict(inpaintnet_from_jax(inpaint_vars))
    with torch.no_grad():
        got = model(torch.from_numpy(coords), torch.from_numpy(mask))
    assert got.shape == (5, 16, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_inpaintnet_conversion_round_trip(inpaint_vars):
    back = inpaintnet_to_jax(inpaintnet_from_jax(inpaint_vars))
    flat_a = jax.tree_util.tree_leaves_with_path(inpaint_vars["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat_a) == len(flat_b) == 18
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_inpaintnet_init_is_lecun_normal_and_seeded():
    a = get_model("InpaintNet", generator=torch.Generator().manual_seed(3))
    b = get_model("InpaintNet", generator=torch.Generator().manual_seed(3))
    assert isinstance(a, InpaintNet)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    w = a.bottleneck_1.conv.weight  # fan_in 128 * 3
    assert abs(float(w.detach().std()) - (1 / 384) ** 0.5) < 0.1 * (1 / 384) ** 0.5
    assert float(a.bottleneck_1.conv.bias.detach().abs().max()) == 0.0


def test_inpaintnet_checkpoint_jax_to_port(tmp_path, inpaint_vars):
    path = str(tmp_path / "InpaintNet_best.pt")
    jckpt.save_checkpoint(path, epoch=2, max_val_acc=0.5, model=inpaint_vars,
                          param_dict=dict(model_name="InpaintNet", seq_len=16))
    model, pd = tckpt.load_model_from_checkpoint(path)
    assert isinstance(model, InpaintNet) and pd["seq_len"] == 16
    for name, t in inpaintnet_from_jax(inpaint_vars).items():
        assert torch.equal(model.state_dict()[name], t), name


def test_inpaintnet_checkpoint_port_to_jax(tmp_path):
    model = get_model("InpaintNet", generator=torch.Generator().manual_seed(4))
    path = str(tmp_path / "InpaintNet_cur.pt")
    tckpt.save_checkpoint(path, epoch=0, max_val_acc=0.0, model=model,
                          param_dict=dict(model_name="InpaintNet", seq_len=16))
    _, variables, pd = jckpt.load_model_from_checkpoint(path)
    assert pd["model_name"] == "InpaintNet"
    want = inpaintnet_to_jax(model)
    for path_, leaf in jax.tree_util.tree_leaves_with_path(want["params"]):
        got = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))[path_]
        np.testing.assert_array_equal(np.asarray(got), leaf)
