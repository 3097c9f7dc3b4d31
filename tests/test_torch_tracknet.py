"""The port's TrackNet vs the JAX package's on the CPU.

Weights come from a JAX random init (``models/factory.py::get_model``) via
``tracknet_from_jax``. Train mode vs ``tracknet_train_forward`` (concat up
blocks) in float64 (logits 1e-9) and in float32 (logits 2e-4, new running
mean/var atol 1e-5). Eval mode in float32 vs ``TrackNet.apply(train=False)``
(1e-4). The weight conversion round-trips exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.models import get_model as jax_get_model  # noqa: E402
from tracknetv3_tpu.models.fused_forward import tracknet_train_forward  # noqa: E402
from tracknetv3_tpu_torch.models.convert import (  # noqa: E402
    JAX_PARAM_PATHS,
    tracknet_from_jax,
    tracknet_to_jax,
)
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402

SEQ, BG, N, HGT, WDT = 3, "concat", 2, 32, 64


@pytest.fixture(scope="module")
def jax_model():
    module, variables = jax_get_model(
        "TrackNet", SEQ, BG, rng=jax.random.PRNGKey(0), compute_dtype=jnp.float32
    )
    return module, jax.tree_util.tree_map(np.asarray, variables)


def _port(variables):
    model = get_model("TrackNet", SEQ, BG, dtype=torch.float32)
    model.load_state_dict(tracknet_from_jax(variables))
    return model


def _x(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (N, HGT, WDT, 12)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _train_forwards(v, x, jdtype, tdtype):
    with jax.enable_x64(jdtype == jnp.float64):
        want, new_stats = tracknet_train_forward(
            v["params"], v["batch_stats"], jnp.asarray(x, jdtype), train=True,
            dtype=jdtype, split_up_entry=False,
        )
        want = np.asarray(want)
        new_stats = jax.tree_util.tree_map(np.asarray, new_stats)
    model = _port(v).to(tdtype).train()
    model.dtype = tdtype
    got = model(_nchw(x).to(tdtype))
    assert got.dtype == tdtype and got.shape == (N, SEQ, HGT, WDT)
    assert got.is_contiguous()
    return want, new_stats, got.detach().movedim(1, -1).numpy(), tracknet_to_jax(model)


def _assert_stats_close(want_stats, got_vars, atol):
    flat_w = jax.tree_util.tree_leaves_with_path(want_stats)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got_vars["batch_stats"]))
    assert len(flat_w) == len(flat_g) == 17 * 2
    for path, want_leaf in flat_w:
        np.testing.assert_allclose(flat_g[path], want_leaf, atol=atol, rtol=0)


def test_train_forward_and_batch_stats_match_float64(jax_model):
    """The algorithm, free of float32 rounding: both packages in float64."""
    _, v = jax_model
    want, stats, got, port_vars = _train_forwards(v, _x(), jnp.float64, torch.float64)
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=1e-9)
    # the JAX update multiplies the float32 old stats by 0.9 in float32
    # before adding the float64 batch term: ~2.4e-8 from the float64 value
    _assert_stats_close(stats, port_vars, atol=1e-7)


def test_train_forward_and_batch_stats_match_float32(jax_model):
    """float32 against float32. Train-mode BatchNorm over few samples (64
    per channel at the bottleneck) amplifies reduction-order rounding: each
    package is up to ~1e-4 from the float64 result here, so the logits are
    held to atol/rtol 2e-4, and the running stats to atol 1e-5."""
    _, v = jax_model
    want, stats, got, port_vars = _train_forwards(v, _x(), jnp.float32, torch.float32)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    _assert_stats_close(stats, port_vars, atol=1e-5)


def test_eval_forward_matches_flax_apply(jax_model):
    module, v = jax_model
    # non-trivial running stats: one train forward's update
    _, stats = tracknet_train_forward(
        v["params"], v["batch_stats"], jnp.asarray(_x(1)), train=True,
        dtype=jnp.float32, split_up_entry=False,
    )
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(np.asarray, stats)}
    x = _x(2)
    want = module.apply(v, jnp.asarray(x), train=False)
    model = _port(v).eval()
    with torch.no_grad():
        got = model(_nchw(x))
    np.testing.assert_allclose(got.movedim(1, -1).numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_weight_conversion_round_trips_exactly(jax_model):
    _, v = jax_model
    back = tracknet_to_jax(_port(v))
    w_leaves, w_def = jax.tree_util.tree_flatten(v)
    g_leaves, g_def = jax.tree_util.tree_flatten(back)
    assert w_def == g_def
    for a, b in zip(w_leaves, g_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_param_paths_follow_jax_flatten_order(jax_model):
    _, v = jax_model
    paths = [
        tuple(k.key for k in p)
        for p, _ in jax.tree_util.tree_leaves_with_path(v["params"])
    ]
    assert paths == JAX_PARAM_PATHS


def test_fresh_init_is_seeded_and_flax_scaled():
    a = get_model("TrackNet", SEQ, BG, generator=torch.Generator().manual_seed(4))
    b = get_model("TrackNet", SEQ, BG, generator=torch.Generator().manual_seed(4))
    for (ka, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(pa, pb), ka
    w = a.up_block_1.conv_1.conv.weight.detach()  # fan_in 768 * 9
    assert abs(float(w.std()) - (1.0 / (768 * 9)) ** 0.5) < 0.05 * (1.0 / (768 * 9)) ** 0.5
    assert float(a.predictor.bias.detach().abs().max()) == 0.0
