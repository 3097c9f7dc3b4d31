"""The port's BatchNorm + ReLU op (``ops/batchnorm.py``) vs the JAX package
on the CPU, where the op runs its plain versions (the CUDA kernels are held
to the same plain versions on the card by ``chip_smoke.py``).

- Train and eval mode in float64 against ``jax.vjp`` of flax's
  ``BatchNorm`` + ``jnp.maximum`` with the settings of the JAX package's
  ``ConvBNRelu`` (``tracknetv3_tpu/models/tracknet.py:54-62``) widened to
  float64 (``ConvBNRelu`` casts to float32 itself): output, running
  statistics and every gradient within 1e-10.
- Train and eval mode in float32 against ``jax.vjp`` of ``ConvBNRelu``
  itself (conv included), within the bound stated at the test.
- The ReLU tie: where ``z == 0`` exactly, ``jnp.maximum`` passes half the
  gradient; a constant channel in the layer, and a zeroed output channel
  of ``down_block_1/conv_1`` in the whole float64 train step, give JAX's
  BN-bias gradient (atol 1e-12).
- The hand-derived backward against finite differences (``gradcheck``).
- What the CUDA wrappers refuse, checked through ``check_kernel_input``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402

from tracknetv3_tpu.models import get_model as jax_get_model  # noqa: E402
from tracknetv3_tpu.models.fused_forward import tracknet_train_forward  # noqa: E402
from tracknetv3_tpu.models.tracknet import ConvBNRelu as JaxConvBNRelu  # noqa: E402
from tracknetv3_tpu.ops.losses import wbce_from_logits as jax_wbce_from_logits  # noqa: E402
from tracknetv3_tpu.training import steps as jax_steps  # noqa: E402
from tracknetv3_tpu_torch.models.convert import tracknet_from_jax  # noqa: E402
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402
from tracknetv3_tpu_torch.models.tracknet import ConvBNRelu  # noqa: E402
from tracknetv3_tpu_torch.ops import batchnorm as bnm  # noqa: E402
from tracknetv3_tpu_torch.ops.losses import wbce_from_logits  # noqa: E402
from tracknetv3_tpu_torch.training.steps import (  # noqa: E402
    _to_model_input,
    assemble_tracknet_inputs,
    assemble_tracknet_labels,
)
from tracknetv3_tpu_torch.utils import profiling  # noqa: E402

N, H, W, CIN, C = 4, 16, 32, 8, 16  # 2048 rows of a layer


def _layer_data(seed, const_channel=None):
    """NHWC conv outputs with per-channel means well away from 0, the
    output cotangent, and the BN parameters and running statistics."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((N, H, W, C)) * rng.uniform(0.5, 2.0, C) + rng.uniform(-3, 3, C)
    if const_channel is not None:
        y[..., const_channel] = 3.0
    g = rng.standard_normal((N, H, W, C))
    gamma = rng.uniform(0.5, 1.5, C)
    beta = rng.uniform(-0.5, 0.5, C)
    if const_channel is not None:
        beta[const_channel] = 0.0  # z = (3 - 3) * inv + 0: a tie
    rm, rv = rng.uniform(-1, 1, C), rng.uniform(0.5, 2.0, C)
    return y, g, gamma, beta, rm, rv


def _nchw(a, dtype):
    """An NHWC numpy array as the NCHW view of channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _flax_bn_relu_f64(y, g, gamma, beta, rm, rv, train):
    """flax BatchNorm as ``ConvBNRelu`` configures it, in float64, then
    ``jnp.maximum(., 0)``: (out, dy, dgamma, dbeta, new running mean, var)."""
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.float64, param_dtype=jnp.float64)
    stats = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}

    def f(y, scale, bias):
        out, upd = bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats},
                            y, mutable=["batch_stats"])
        return jnp.maximum(out, 0.0), upd["batch_stats"]

    out, vjp, new = jax.vjp(f, jnp.asarray(y), jnp.asarray(gamma), jnp.asarray(beta),
                            has_aux=True)
    dy, dgamma, dbeta = vjp(jnp.asarray(g))
    return [np.asarray(a) for a in (out, dy, dgamma, dbeta, new["mean"], new["var"])]


def _port_bn_relu(y, g, gamma, beta, rm, rv, train, dtype):
    """The port's op on the CPU: the same six arrays."""
    yt = _nchw(y, dtype).requires_grad_()
    w = torch.tensor(gamma, dtype=dtype, requires_grad=True)
    b = torch.tensor(beta, dtype=dtype, requires_grad=True)
    rmt, rvt = torch.tensor(rm, dtype=dtype), torch.tensor(rv, dtype=dtype)
    op = bnm.bn_relu_train if train else bnm.bn_relu_eval
    out = op(yt, w, b, rmt, rvt)
    out.backward(_nchw(g, dtype))
    return [_nhwc(out), _nhwc(yt.grad), w.grad.numpy(), b.grad.numpy(), rmt.numpy(),
            rvt.numpy()]


NAMES = ("out", "dy", "dgamma", "dbeta", "running_mean", "running_var")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bn_relu_matches_flax_float64(train):
    data = _layer_data(0)
    with jax.enable_x64(True):
        want = _flax_bn_relu_f64(*data, train)
    got = _port_bn_relu(*data, train, torch.float64)
    assert (want[0] > 0).mean() > 0.3 and (want[0] == 0).mean() > 0.1  # the mask matters
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, atol=1e-10, rtol=1e-10, err_msg=name)


def test_relu_tie_in_a_constant_channel_matches_flax():
    """A constant channel with zero bias: var = 0 and z == 0 exactly, where
    ``jnp.maximum`` passes half the gradient. ``torch.relu`` passes none:
    dbeta of that channel would be 0."""
    data = _layer_data(1, const_channel=5)
    with jax.enable_x64(True):
        want = _flax_bn_relu_f64(*data, True)
    got = _port_bn_relu(*data, True, torch.float64)
    assert abs(want[3][5] - 0.5 * data[1][..., 5].sum()) < 1e-9
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, atol=1e-10, rtol=1e-10, err_msg=name)


# float32 against the JAX package's ConvBNRelu (conv + BN + ReLU). Each side
# rounds in float32 in its own order (the port's statistics sum in float64,
# flax's in float32); the readings were <= 9.0e-7 relative L2 (train) and
# <= 1.0e-6 (eval) over the seven arrays, so the bound is 1e-5.
F32_REL_L2 = 1e-5


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_conv_bn_relu_matches_jax_layer_float32(train):
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (N, H, W, CIN)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, CIN, C)) / np.sqrt(9 * CIN)).astype(np.float32)
    _, g, gamma, beta, rm, rv = (np.asarray(a, np.float32) for a in _layer_data(3))
    layer = JaxConvBNRelu(C, dtype=jnp.float32)
    stats = {"bn": {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}}

    def f(x, kernel, scale, bias):
        params = {"conv": {"kernel": kernel}, "bn": {"scale": scale, "bias": bias}}
        out, upd = layer.apply({"params": params, "batch_stats": stats}, x, train=train,
                               mutable=["batch_stats"])
        return out, upd["batch_stats"]["bn"]

    out, vjp, new = jax.vjp(f, *(jnp.asarray(a) for a in (x, kernel, gamma, beta)),
                            has_aux=True)
    want = [out, *vjp(jnp.asarray(g)), new["mean"], new["var"]]

    m = ConvBNRelu(CIN, C).train(train)
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        for name, v in (("weight", gamma), ("bias", beta), ("running_mean", rm),
                        ("running_var", rv)):
            getattr(m.bn, name).copy_(torch.from_numpy(v))
    xt = _nchw(x, torch.float32).requires_grad_()
    got_out = m(xt, torch.float32)
    got_out.backward(_nchw(g, torch.float32))
    got = [_nhwc(got_out), _nhwc(xt.grad), m.conv.weight.grad.numpy().transpose(2, 3, 1, 0),
           m.bn.weight.grad.numpy(), m.bn.bias.grad.numpy(), m.bn.running_mean.numpy(),
           m.bn.running_var.numpy()]
    for name, a, b in zip(("out", "dx", "dkernel") + NAMES[2:], got, want):
        b = np.asarray(b)
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel <= F32_REL_L2, (name, rel)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_hand_derived_backward_matches_finite_differences(train):
    rng = np.random.default_rng(4)
    y = torch.from_numpy(rng.standard_normal((2, 8, 3, 4)) + 1.0).requires_grad_()
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 8)).requires_grad_()
    b = torch.from_numpy(rng.uniform(-0.5, 0.5, 8)).requires_grad_()
    rm, rv = torch.zeros(8, dtype=torch.float64), torch.ones(8, dtype=torch.float64)
    op = bnm.bn_relu_train_plain if train else bnm.bn_relu_eval_plain
    assert torch.autograd.gradcheck(lambda y, w, b: op(y, w, b, rm.clone(), rv.clone()),
                                    (y, w, b))


# ---------------------------------------------------------------- the whole step

SEQ, BG, NB, HGT, WDT = 3, "concat", 2, 32, 64
TIE_CHANNEL = 5


def _batch():
    rng = np.random.default_rng(0)
    return {
        "rgb": rng.integers(0, 256, (NB, SEQ, HGT, WDT, 3), dtype=np.uint8),
        "median": rng.integers(0, 256, (NB, HGT, WDT, 3), dtype=np.uint8),
        "cxcy": np.stack([rng.integers(1, WDT - 1, (NB, SEQ)),
                          rng.integers(1, HGT - 1, (NB, SEQ))], -1).astype(np.int32),
    }


def test_train_step_gradient_at_a_relu_tie_matches_jax():
    """Output channel 5 of down_block_1/conv_1 has a zero kernel: y = 0,
    var = 0 and z = bias = 0 exactly at init. The float64 step's gradient of
    that BatchNorm's bias equals JAX's (-1.65e-4 for the channel; 0 with
    ``torch.relu``)."""
    _, variables = jax_get_model("TrackNet", SEQ, BG, rng=jax.random.PRNGKey(1),
                                 compute_dtype=jnp.float32)
    variables = jax.tree_util.tree_map(np.array, variables)
    variables["params"]["down_block_1"]["conv_1"]["conv"]["kernel"][..., TIE_CHANNEL] = 0.0
    batch = _batch()
    with jax.enable_x64(True):
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss_fn(params):
            x, y = jax_steps.assemble_tracknet_batch({k: jnp.asarray(v) for k, v in
                                                      batch.items()}, BG)
            logits, _ = tracknet_train_forward(params, jv["batch_stats"], x, train=True,
                                               dtype=jnp.float64, split_up_entry=False)
            return jax_wbce_from_logits(logits, y)

        grads = jax.jit(jax.grad(loss_fn))(jv["params"])
        want = np.asarray(grads["down_block_1"]["conv_1"]["bn"]["bias"])

    model = get_model("TrackNet", SEQ, BG, dtype=torch.float64)
    model.load_state_dict(tracknet_from_jax(variables))
    model = model.to(torch.float64).train()
    model.dtype = torch.float64
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    x = assemble_tracknet_inputs(tb, BG).double()
    logits = model(_to_model_input(x))
    loss = wbce_from_logits(logits.movedim(1, -1), assemble_tracknet_labels(tb, HGT, WDT))
    loss.backward()
    got = model.down_block_1.conv_1.bn.bias.grad.numpy()
    assert abs(want[TIE_CHANNEL]) > 1e-6
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


# ---------------------------------------------------------------- the CUDA wrappers


def _cl(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("x, match", [
    (lambda: _cl((2, 64, 4, 4)), None),
    (lambda: _cl((2, 512, 2, 2), torch.float32), None),
    (lambda: _cl((2, 64, 4, 4), torch.float64), "bfloat16 or float32"),
    (lambda: _cl((2, 64, 4, 4), torch.float16), "bfloat16 or float32"),
    (lambda: torch.zeros((2, 64, 4, 4), dtype=torch.bfloat16), "channels_last"),
    (lambda: _cl((2, 4, 4, 4)), "16-byte groups"),
    (lambda: _cl((2, 24, 4, 4)), "16-byte groups"),
    (lambda: _cl((0, 64, 4, 4)), "non-empty"),
    (lambda: torch.zeros((64, 4, 4), dtype=torch.bfloat16), "4-D"),
])
def test_kernel_input_checks(x, match):
    """What the CUDA wrappers validate before they launch."""
    if match is None:
        bnm.check_kernel_input(x())
    else:
        with pytest.raises(ValueError, match=match):
            bnm.check_kernel_input(x())


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    before = profiling.counters()
    y, g, gamma, beta, rm, rv = (torch.from_numpy(np.asarray(a, np.float32))
                                 for a in _layer_data(5))
    y, g = y.permute(0, 3, 1, 2).to(torch.bfloat16), g.permute(0, 3, 1, 2).to(torch.bfloat16)
    rm2, rv2 = rm.clone(), rv.clone()
    st = bnm.bn_stats(y, gamma, rm, rv)
    assert torch.equal(st, bnm.bn_stats_plain(y, gamma, rm2, rv2))
    assert torch.equal(rm, rm2) and torch.equal(rv, rv2)
    out = bnm.bn_relu_fwd(y, st, beta)
    assert out.dtype == torch.bfloat16 and torch.equal(out, bnm.bn_relu_fwd_plain(y, st, beta))
    dg, db, coef = bnm.bn_relu_bwd_reduce(g, y, st, beta, True)
    for a, b in zip((dg, db, coef), bnm.bn_relu_bwd_reduce_plain(g, y, st, beta, True)):
        assert torch.equal(a, b)
    dy = bnm.bn_relu_bwd_apply(g, y, st, beta, coef)
    assert torch.equal(dy, bnm.bn_relu_bwd_apply_plain(g, y, st, beta, coef))
    assert profiling.counters() == before
