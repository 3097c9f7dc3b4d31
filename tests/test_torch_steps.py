"""The port's TrackNet train / eval steps vs the JAX package's on the CPU,
at 32x64, seq_len 3, bg_mode concat, batch 2.

- One ``alpha=0`` Adam step from the same weights and batch vs the JAX step
  (``pallas_loss=False``), both in float64: loss rtol 1e-5, each parameter
  gradient within relative L2 1e-4, new batch stats atol 1e-5, updated
  parameters atol 1e-6 where |g| > 1e-6 (the first Adam step is
  ~lr * sign(g), which amplifies noise in gradients near zero); and both
  in float32 (see the test for its gradient bound).
- Sample mixup with a fixed numpy perm/lam: the mixed input and the packed
  targets equal JAX's ``x*lx + x[perm]*(1-lx)`` and ``pack_mixup_targets``.
- The eval step's loss and probabilities vs the JAX eval computation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.models import get_model as jax_get_model  # noqa: E402
from tracknetv3_tpu.models.fused_forward import tracknet_train_forward  # noqa: E402
from tracknetv3_tpu.ops import pallas_wbce as pw  # noqa: E402
from tracknetv3_tpu.ops.losses import wbce as jax_wbce  # noqa: E402
from tracknetv3_tpu.ops.losses import wbce_from_logits as jax_wbce_from_logits  # noqa: E402
from tracknetv3_tpu.training import optim as jax_optim  # noqa: E402
from tracknetv3_tpu.training import steps as jax_steps  # noqa: E402
from tracknetv3_tpu_torch.models.convert import (  # noqa: E402
    PARAM_MAP,
    torch_to_jax_layout,
    tracknet_from_jax,
    tracknet_to_jax,
)
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402
from tracknetv3_tpu_torch.training import optim, steps  # noqa: E402

SEQ, BG, N, HGT, WDT = 3, "concat", 2, 32, 64


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "rgb": rng.integers(0, 256, (N, SEQ, HGT, WDT, 3), dtype=np.uint8),
        "median": rng.integers(0, 256, (N, HGT, WDT, 3), dtype=np.uint8),
        "cxcy": np.stack(
            [rng.integers(1, WDT - 1, (N, SEQ)), rng.integers(1, HGT - 1, (N, SEQ))], -1
        ).astype(np.int32),
        "id": np.zeros((N, SEQ, 2), np.int32),
    }


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def init_vars():
    _, variables = jax_get_model(
        "TrackNet", SEQ, BG, rng=jax.random.PRNGKey(1), compute_dtype=jnp.float32
    )
    return jax.tree_util.tree_map(np.asarray, variables)


def _port_model(variables):
    model = get_model("TrackNet", SEQ, BG, dtype=torch.float32)
    model.load_state_dict(tracknet_from_jax(variables))
    return model


# float64: the algorithm, held to the stated tolerances. float32: at this
# size train-mode BatchNorm amplifies rounding, and each package's float32
# gradients are off the float64 ones by up to ~6e-4 (port) and ~7e-3 (JAX)
# in relative L2, so float32 gradients are held to 2e-2 and float32
# parameters (whose first Adam step follows sign(g)) are not compared.
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_adam_step_matches_jax(init_vars, dtype):
    jdt, tdt = {"float64": (jnp.float64, torch.float64),
                "float32": (jnp.float32, torch.float32)}[dtype]
    batch = _batch()
    with jax.enable_x64(dtype == "float64"):
        tx = jax_optim.build_optimizer("Adam", 1e-3)
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), init_vars)
        state = jax_steps.create_train_state(jvars, tx)
        jstep = jax_steps.make_tracknet_train_step(
            tx, BG, alpha=0.0, pallas_loss=False, dtype=jdt, split_up_entry=False
        )

        def loss_fn(params, stats, b):
            x, y = jax_steps.assemble_tracknet_batch(b, BG)
            logits, _ = tracknet_train_forward(
                params, stats, x, train=True, dtype=jdt, split_up_entry=False
            )
            return jax_wbce_from_logits(logits, y)

        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        j_grads = jax.jit(jax.grad(loss_fn))(state.params, state.batch_stats, jbatch)
        j_grads = jax.tree_util.tree_map(np.asarray, j_grads)
        new_state, j_loss = jstep(state, jbatch, jax.random.PRNGKey(0))
        j_loss = float(j_loss)
        new_params = jax.tree_util.tree_map(np.asarray, new_state.params)
        want_stats = jax.tree_util.tree_map(np.asarray, new_state.batch_stats)

    model = _port_model(init_vars).to(tdt)
    model.dtype = tdt
    opt, schedule = optim.build_optimizer("Adam", model.parameters(), 1e-3)
    step = steps.make_tracknet_train_step(model, opt, BG, alpha=0.0, schedule=schedule)
    loss = step(_tensors(batch), 0)

    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    params = dict(model.named_parameters())
    for path, name in PARAM_MAP:
        g_want = _get(j_grads, path)
        g_got = torch_to_jax_layout(params[name].grad.numpy())
        rel = np.linalg.norm(g_got - g_want) / max(np.linalg.norm(g_want), 1e-30)
        assert rel <= (1e-4 if dtype == "float64" else 2e-2), (name, rel)
        if dtype == "float64":
            big = np.abs(g_want) > 1e-6
            p_got = torch_to_jax_layout(params[name].detach().numpy())
            np.testing.assert_allclose(p_got[big], _get(new_params, path)[big], atol=1e-6,
                                       rtol=0, err_msg=name)
    got_stats = tracknet_to_jax(model)["batch_stats"]
    for (path, want), (_, got) in zip(
        jax.tree_util.tree_leaves_with_path(want_stats),
        jax.tree_util.tree_leaves_with_path(got_stats),
    ):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=str(path))


def test_mixup_inputs_and_targets_match_jax():
    batch = _batch(3)
    perm = np.array([1, 0])
    lam = np.array([0.8, 0.6], np.float32)
    jx = jax_steps.assemble_tracknet_inputs({k: jnp.asarray(v) for k, v in batch.items()}, BG)
    lx = jnp.asarray(lam).reshape(N, 1, 1, 1)
    want_x = np.asarray(jx * lx + jx[perm] * (1.0 - lx))
    want_c, want_w = pw.pack_mixup_targets(jnp.asarray(batch["cxcy"]), jnp.asarray(perm),
                                           jnp.asarray(lam))

    tb = _tensors(batch)
    x = steps.assemble_tracknet_inputs(tb, BG)
    # XLA rewrites x / 255 as x * (1 / 255): at most 1 ulp (6e-8 below 1)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=6e-8, rtol=0)
    got_x = steps.sample_mixup_inputs(torch.tensor(np.asarray(jx)), torch.from_numpy(perm),
                                      torch.from_numpy(lam))
    np.testing.assert_allclose(got_x.numpy(), want_x, atol=1e-7, rtol=0)
    got_c, got_w = steps.pack_mixup_targets(tb["cxcy"], torch.from_numpy(perm),
                                            torch.from_numpy(lam))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


def test_sample_mixup_params_are_seeded_host_draws():
    p1, l1 = steps.sample_mixup_params(np.random.default_rng(7), 10, 0.5)
    p2, l2 = steps.sample_mixup_params(np.random.default_rng(7), 10, 0.5)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(l1, l2)
    assert sorted(p1.tolist()) == list(range(10)) and p1.dtype == np.int64
    assert l1.dtype == np.float32 and np.all((l1 >= 0.5) & (l1 <= 1.0))


def test_eval_step_matches_jax(init_vars):
    batch = _batch(5)
    # running stats after one JAX train-mode forward, so eval uses real ones
    _, stats = tracknet_train_forward(
        init_vars["params"], init_vars["batch_stats"],
        jax_steps.assemble_tracknet_inputs({k: jnp.asarray(v) for k, v in _batch(6).items()}, BG),
        train=True, dtype=jnp.float32,
    )
    variables = {"params": init_vars["params"],
                 "batch_stats": jax.tree_util.tree_map(np.asarray, stats)}
    # the JAX eval step's body (make_tracknet_eval_step) in float32
    x, y = jax_steps.assemble_tracknet_batch({k: jnp.asarray(v) for k, v in batch.items()}, BG)
    logits, _ = tracknet_train_forward(
        variables["params"], variables["batch_stats"], x, train=False, dtype=jnp.float32
    )
    want_probs = jax.nn.sigmoid(logits)
    want_loss = jax_wbce(want_probs, y)

    model = _port_model(variables)
    loss, probs = steps.make_tracknet_eval_step(model, BG)(_tensors(batch))
    assert probs.shape == (N, HGT, WDT, SEQ)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    # eval leaves the running stats alone
    for k, v in tracknet_from_jax(variables).items():
        if "running" in k:
            assert torch.equal(model.state_dict()[k], v)


def test_steplr_schedule_matches_optax():
    sched = optim.build_schedule(1e-3, "StepLR", epochs=6, steps_per_epoch=5)
    ref = jax_optim.build_schedule(1e-3, "StepLR", 6, 5)
    for s in range(0, 40):
        np.testing.assert_allclose(sched(s), float(ref(s)), rtol=1e-6)
