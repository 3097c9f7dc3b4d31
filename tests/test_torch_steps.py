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
- Segmented, device-resident and frame-mixup batches: the assembled input
  against JAX's (the copies bit for bit; the frame-mixup blend within 2
  float32 spacings at 255, since XLA may contract one of its two products
  into a fused multiply-add). The Adam step on such batches is held to the
  JAX step in ``test_torch_steps_mixup.py``, with this file's helpers.
"""

import functools
from unittest import mock

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


def _check_step_matches_jax(init_vars, batch, dtype, alpha=0.0, pallas=False):
    """One Adam step of both packages from the same weights and batch: loss,
    every parameter gradient, the updated parameters (float64) and the new
    batch statistics. With ``alpha > 0`` the port gets the perm / lam that
    the JAX step draws from its key; with ``pallas`` the JAX step takes its
    Pallas loss (interpret mode) wherever it would on a TPU."""
    jdt, tdt = {"float64": (jnp.float64, torch.float64),
                "float32": (jnp.float32, torch.float32)}[dtype]
    key = jax.random.PRNGKey(0)
    interp = functools.partial(pw.wbce_disk_loss, sigma=pw.SIGMA, interpret=True)
    with jax.enable_x64(dtype == "float64"), mock.patch.object(
            pw, "wbce_disk_loss", lambda z, c, w: interp(z, c, w)):
        tx = jax_optim.build_optimizer("Adam", 1e-3)
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), init_vars)
        state = jax_steps.create_train_state(jvars, tx)
        jstep = jax_steps.make_tracknet_train_step(
            tx, BG, alpha=alpha, pallas_loss=pallas, dtype=jdt, split_up_entry=False
        )
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        perm = lam = None
        if alpha > 0:
            _, perm, lam = jax_steps.sample_mixup_inputs(
                key, jax_steps.assemble_tracknet_inputs(jbatch, BG), alpha)

        def loss_fn(params, stats, b):  # the step's function on materialised labels
            x, y = jax_steps.assemble_tracknet_batch(b, BG)
            if alpha > 0:
                lx = lam.reshape((-1, 1, 1, 1))
                x = x * lx + x[perm] * (1.0 - lx)
                y = y * lx + y[perm] * (1.0 - lx)
            logits, _ = tracknet_train_forward(
                params, stats, x, train=True, dtype=jdt, split_up_entry=False
            )
            return jax_wbce_from_logits(logits, y)

        j_grads = jax.jit(jax.grad(loss_fn))(state.params, state.batch_stats, jbatch)
        j_grads = jax.tree_util.tree_map(np.asarray, j_grads)
        new_state, j_loss = jstep(state, jbatch, key)
        j_loss = float(j_loss)
        new_params = jax.tree_util.tree_map(np.asarray, new_state.params)
        want_stats = jax.tree_util.tree_map(np.asarray, new_state.batch_stats)
        if alpha > 0:
            perm, lam = np.array(perm, np.int64), np.array(lam)

    model = _port_model(init_vars).to(tdt)
    model.dtype = tdt
    opt, schedule = optim.build_optimizer("Adam", model.parameters(), 1e-3)
    step = steps.make_tracknet_train_step(model, opt, BG, alpha=alpha, schedule=schedule)
    mix = () if alpha <= 0 else (torch.from_numpy(perm), torch.from_numpy(lam))
    loss = step(_tensors(batch), 0, *mix)

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


# float64: the algorithm, held to the stated tolerances. float32: at this
# size train-mode BatchNorm amplifies rounding, and each package's float32
# gradients are off the float64 ones by up to ~6e-4 (port) and ~7e-3 (JAX)
# in relative L2, so float32 gradients are held to 2e-2 and float32
# parameters (whose first Adam step follows sign(g)) are not compared.
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_adam_step_matches_jax(init_vars, dtype):
    _check_step_matches_jax(init_vars, _batch(), dtype)


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


# ------------------------------------------------ segmented, resident, frame mixup

SEG = 2  # windows per segment: one segment of SEG + SEQ - 1 frames makes the batch of 2


def _segmented_batch(seed=0, n_seg=N // SEG, bg_mode=BG):
    rng = np.random.default_rng(seed)
    span = SEG + SEQ - 1
    b = {"id": np.zeros((n_seg * SEG, SEQ, 2), np.int32)}
    b["cxcy"] = np.stack([rng.integers(1, WDT - 1, (n_seg * SEG, SEQ)),
                          rng.integers(1, HGT - 1, (n_seg * SEG, SEQ))], -1).astype(np.int32)
    if bg_mode in ("", "concat", "subtract_concat"):
        b["seg_rgb"] = rng.integers(0, 256, (n_seg, span, HGT, WDT, 3), dtype=np.uint8)
    if bg_mode in ("subtract", "subtract_concat"):
        b["seg_diff"] = rng.integers(0, 256, (n_seg, span, HGT, WDT, 1), dtype=np.uint8)
    if bg_mode == "concat":
        b["median"] = rng.integers(0, 256, (n_seg, HGT, WDT, 3), dtype=np.uint8)
    return b


def _expanded(batch):
    """The plain batch that holds a segmented batch's windows (numpy)."""
    out = {k: v for k, v in batch.items() if not k.startswith("seg_")}
    for k in ("seg_rgb", "seg_diff"):
        if k in batch:
            segs = batch[k]
            out[k[4:]] = np.stack([segs[s, j : j + SEQ] for s in range(segs.shape[0])
                                   for j in range(SEG)])
    if "median" in batch:
        out["median"] = np.repeat(batch["median"], SEG, 0)
    return out


def _frame_mixup_batch(seed=0):
    rng = np.random.default_rng(seed)
    b = _batch(seed)
    b["mix_pair"] = rng.integers(0, SEQ, (N, SEQ, 2)).astype(np.int32)
    b["mix_pix_w"] = rng.random((N, SEQ)).astype(np.float32)
    b["mix_pix_w"][0, 0] = 1.0  # a slot that keeps its own frame
    b["mix_centers"] = np.stack(
        [rng.integers(0, WDT, (N, SEQ, 2)), rng.integers(0, HGT, (N, SEQ, 2))], -1
    ).astype(np.int32)
    b["mix_hm_w"] = rng.random((N, SEQ)).astype(np.float32)
    return b


def _jax_inputs(batch, bg_mode):
    return np.asarray(jax_steps.assemble_tracknet_inputs(
        {k: jnp.asarray(v) for k, v in batch.items()}, bg_mode))


@pytest.mark.parametrize("bg_mode", ["concat", "", "subtract", "subtract_concat"])
@pytest.mark.parametrize("n_seg", [1, 3])  # 3: a batch of another size (the short tail)
def test_segmented_inputs_match_jax(bg_mode, n_seg):
    batch = _segmented_batch(2, n_seg, bg_mode)
    got = steps.assemble_tracknet_inputs(_tensors(batch), bg_mode)
    plain = steps.assemble_tracknet_inputs(_tensors(_expanded(batch)), bg_mode)
    assert got.dtype == torch.float32 and got.shape[0] == n_seg * SEG
    assert torch.equal(got, plain)  # the expansion is a copy
    want, want_plain = _jax_inputs(batch, bg_mode), _jax_inputs(_expanded(batch), bg_mode)
    np.testing.assert_array_equal(want, want_plain)  # and so is JAX's
    # XLA rewrites x / 255 as x * (1 / 255): at most 1 ulp (6e-8 below 1)
    np.testing.assert_allclose(got.numpy(), want, atol=6e-8, rtol=0)
    # the pixels themselves, before the division: bit for bit
    np.testing.assert_array_equal(np.rint(got.numpy() * 255), np.rint(want * 255))


@pytest.mark.parametrize("bg_mode", ["concat", "", "subtract_concat"])
def test_resident_inputs_match_jax(bg_mode):
    rng = np.random.default_rng(4)
    T = 9
    batch = {"cxcy": _batch()["cxcy"],
             "res_idx": rng.integers(0, T, (N, SEQ)).astype(np.int32)}
    if bg_mode in ("", "concat", "subtract_concat"):
        batch["res_rgb_buf"] = rng.integers(0, 256, (T, HGT, WDT, 3), dtype=np.uint8)
    if bg_mode == "subtract_concat":
        batch["res_diff_buf"] = rng.integers(0, 256, (T, HGT, WDT, 1), dtype=np.uint8)
    if bg_mode == "concat":
        batch["res_median_buf"] = rng.integers(0, 256, (3, HGT, WDT, 3)).astype(np.float32)
        batch["res_median_idx"] = np.array([2, 0], np.int32)
    plain = {"cxcy": batch["cxcy"]}
    for k in ("rgb", "diff"):
        if f"res_{k}_buf" in batch:
            plain[k] = batch[f"res_{k}_buf"][batch["res_idx"]]
    if bg_mode == "concat":
        plain["median"] = batch["res_median_buf"][batch["res_median_idx"]]
    got = steps.assemble_tracknet_inputs(_tensors(batch), bg_mode)
    assert torch.equal(got, steps.assemble_tracknet_inputs(_tensors(plain), bg_mode))
    want = _jax_inputs(batch, bg_mode)
    np.testing.assert_array_equal(want, _jax_inputs(plain, bg_mode))
    np.testing.assert_allclose(got.numpy(), want, atol=6e-8, rtol=0)
    np.testing.assert_array_equal(np.rint(got.numpy() * 255), np.rint(want * 255))


def test_frame_mixup_inputs_and_labels_match_jax():
    batch = _frame_mixup_batch(6)
    tb = _tensors(batch)
    got = steps.assemble_tracknet_inputs(tb, BG)
    want = _jax_inputs(batch, BG)
    # the blend fa * w + fb * (1 - w) in float32 at pixel scale: XLA may fuse
    # one product into the sum (one rounding fewer), eager torch rounds both:
    # 2 spacings of float32 at 255 (2 ** -16 each), divided by 255, and the
    # 1 ulp of the division itself
    bound = 2 * 2.0 ** -16 / 255 + 6e-8
    np.testing.assert_allclose(got.numpy(), want, atol=bound, rtol=0)
    assert not np.array_equal(got.numpy(), _jax_inputs(_batch(6), BG))  # blended indeed
    # a weight of 1 keeps the first frame of the pair (concat: the median's 3
    # channels come first, then slot 0's)
    ja = batch["mix_pair"][0, 0, 0]
    np.testing.assert_array_equal(np.rint(got[0, ..., 3:6].numpy() * 255),
                                  batch["rgb"][0, ja].astype(np.float32))
    y = steps.assemble_tracknet_labels(tb, HGT, WDT)
    want_y = jax_steps.assemble_tracknet_labels({k: jnp.asarray(v) for k, v in batch.items()},
                                                HGT, WDT)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-7, rtol=0)
    got_c, got_w = steps.pack_frame_mixup_targets(tb["mix_centers"], tb["mix_hm_w"])
    want_c, want_w = pw.pack_frame_mixup_targets(jnp.asarray(batch["mix_centers"]),
                                                 jnp.asarray(batch["mix_hm_w"]))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
