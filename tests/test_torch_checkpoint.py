"""Checkpoints between the port and the JAX package (the npz format).

- A port checkpoint loads in JAX's ``load_model_from_checkpoint`` and the
  JAX forward of it matches the port's (float32, atol/rtol 1e-4).
- Its ``opt/`` leaves pass JAX's ``unflatten_optimizer_state`` against a
  fresh optax state of Adam, SGD and Adadelta (with and without StepLR),
  shapes equal, values equal to the port's optimizer state.
- A JAX checkpoint (weights + Adam state) loads into the port exactly.
- Port resume restores the step and the optimizer state: the next step
  from the restored copy equals the next step of the original.
"""

import numpy as np
import pytest
import shutil

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.models import get_model as jax_get_model  # noqa: E402
from tracknetv3_tpu.models.fused_forward import tracknet_train_forward  # noqa: E402
from tracknetv3_tpu.training import checkpoint as jax_ckpt  # noqa: E402
from tracknetv3_tpu.training import optim as jax_optim  # noqa: E402
from tracknetv3_tpu_torch.config import TrainConfig  # noqa: E402
from tracknetv3_tpu_torch.models.convert import (  # noqa: E402
    PARAM_MAP,
    jax_to_torch_layout,
    tracknet_from_jax,
)
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402
from tracknetv3_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from tracknetv3_tpu_torch.training import optim, steps  # noqa: E402

SEQ, BG, N, HGT, WDT = 3, "concat", 2, 32, 64


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "rgb": torch.from_numpy(rng.integers(0, 256, (N, SEQ, HGT, WDT, 3), dtype=np.uint8)),
        "median": torch.from_numpy(rng.integers(0, 256, (N, HGT, WDT, 3), dtype=np.uint8)),
        "cxcy": torch.from_numpy(np.stack(
            [rng.integers(1, WDT - 1, (N, SEQ)), rng.integers(1, HGT - 1, (N, SEQ))], -1
        ).astype(np.int32)),
    }


def _trained(optim_name="Adam", lr_scheduler="", n_steps=1, seed=0):
    """Port model + optimizer after ``n_steps`` float32 steps."""
    model = get_model("TrackNet", SEQ, BG, generator=torch.Generator().manual_seed(seed),
                      dtype=torch.float32)
    opt, sched = optim.build_optimizer(optim_name, model.parameters(), 1e-3, lr_scheduler,
                                       epochs=3, steps_per_epoch=2)
    step = steps.make_tracknet_train_step(model, opt, BG, alpha=0.0, schedule=sched)
    for i in range(n_steps):
        step(_batch(i), i)
    return model, opt, step


def _save(path, model, opt, optim_name, step, lr_scheduler=""):
    pd = TrainConfig(seq_len=SEQ, bg_mode=BG, optim=optim_name,
                     lr_scheduler=lr_scheduler).to_param_dict()
    ckpt.save_checkpoint(
        str(path), epoch=0, max_val_acc=0.5, model=model,
        opt_leaves=ckpt.optimizer_to_jax_leaves(opt, model, optim_name, step,
                                                scheduled=lr_scheduler != ""),
        scheduler=dict(lr_scheduler=lr_scheduler, opt_step=step), param_dict=pd,
    )


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each test's checkpoints and save_dir (a full-width TrackNet checkpoint
    is 130 MB whatever input_hw) go once the test has read them."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_port_checkpoint_loads_in_jax_and_forward_matches(tmp_path):
    model, opt, _ = _trained()
    path = tmp_path / "TrackNet_cur.pt"
    _save(path, model, opt, "Adam", 1)
    _, variables, pd = jax_ckpt.load_model_from_checkpoint(str(path))
    assert pd["seq_len"] == SEQ and pd["bg_mode"] == BG

    x = np.random.default_rng(9).uniform(0, 1, (N, HGT, WDT, 12)).astype(np.float32)
    want, _ = tracknet_train_forward(variables["params"], variables["batch_stats"],
                                     jnp.asarray(x), train=False, dtype=jnp.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).movedim(1, -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("optim_name", ["Adam", "SGD", "Adadelta"])
@pytest.mark.parametrize("lr_scheduler", ["", "StepLR"])
def test_optimizer_leaves_unflatten_in_optax(tmp_path, optim_name, lr_scheduler):
    model, opt, _ = _trained(optim_name, lr_scheduler, n_steps=1)
    path = tmp_path / "ck.pt"
    _save(path, model, opt, optim_name, 1, lr_scheduler)
    loaded = jax_ckpt.load_checkpoint(str(path))

    _, variables = jax_get_model("TrackNet", SEQ, BG, init_params=False)
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), variables["params"])
    tx = jax_optim.build_optimizer(optim_name, 1e-3, lr_scheduler, epochs=3, steps_per_epoch=2)
    ref = tx.init(params)
    restored = jax_ckpt.unflatten_optimizer_state(ref, loaded["optimizer"])
    ref_leaves = jax.tree_util.tree_leaves(ref)
    got_leaves = jax.tree_util.tree_leaves(restored)
    assert [np.shape(a) for a in got_leaves] == [np.shape(a) for a in ref_leaves]
    assert [np.asarray(a).dtype for a in got_leaves] == [np.asarray(a).dtype for a in ref_leaves]

    # the per-parameter leaves hold the port's state, in JAX layouts
    slots = ckpt._SLOTS[optim_name]
    head = 1 if optim_name == "Adam" else 0
    params_by_name = dict(model.named_parameters())
    for j, slot in enumerate(slots):
        for i, (_, name) in enumerate(PARAM_MAP):
            leaf = np.asarray(got_leaves[head + j * len(PARAM_MAP) + i])
            np.testing.assert_array_equal(
                jax_to_torch_layout(leaf), opt.state[params_by_name[name]][slot].numpy()
            )
    if head:
        assert int(got_leaves[0]) == 1
    if lr_scheduler:
        assert int(got_leaves[-1]) == 1


def test_jax_checkpoint_loads_into_port(tmp_path):
    _, variables = jax_get_model("TrackNet", SEQ, BG, rng=jax.random.PRNGKey(3),
                                 compute_dtype=jnp.float32)
    tx = jax_optim.build_optimizer("Adam", 1e-3)
    opt_state = tx.init(variables["params"])
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), variables["params"]
    )
    _, opt_state = jax.jit(tx.update)(grads, opt_state, variables["params"])
    path = tmp_path / "TrackNet_cur.pt"
    jax_ckpt.save_checkpoint(
        str(path), epoch=4, max_val_acc=0.25, model=variables, optimizer=opt_state,
        scheduler=dict(lr_scheduler="", opt_step=1),
        param_dict=dict(model_name="TrackNet", seq_len=SEQ, bg_mode=BG),
    )

    model, pd = ckpt.load_model_from_checkpoint(str(path), dtype=torch.float32)
    assert pd["seq_len"] == SEQ
    want = tracknet_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k

    loaded = ckpt.load_checkpoint(str(path))
    assert loaded["epoch"] == 4 and loaded["scheduler"]["opt_step"] == 1
    opt, _ = optim.build_optimizer("Adam", model.parameters(), 1e-3)
    ckpt.load_optimizer_jax_leaves(opt, model, "Adam", loaded["optimizer"], step=1)
    mu = jax.tree_util.tree_map(np.asarray, opt_state[0].mu)
    params = dict(model.named_parameters())
    for path_, name in PARAM_MAP:
        leaf = mu
        for k in path_:
            leaf = leaf[k]
        np.testing.assert_array_equal(opt.state[params[name]]["exp_avg"].numpy(),
                                      jax_to_torch_layout(leaf))
        assert float(opt.state[params[name]]["step"]) == 1.0


def test_port_resume_restores_step_and_optimizer_state(tmp_path):
    model, opt, step = _trained("Adam", "StepLR", n_steps=2)
    path = tmp_path / "TrackNet_cur.pt"
    _save(path, model, opt, "Adam", 2, "StepLR")

    loaded = ckpt.load_checkpoint(str(path))
    assert loaded["scheduler"] == {"lr_scheduler": "StepLR", "opt_step": 2}
    model2, _ = ckpt.load_model_from_checkpoint(str(path), dtype=torch.float32)
    opt2, sched2 = optim.build_optimizer("Adam", model2.parameters(), 1e-3, "StepLR",
                                         epochs=3, steps_per_epoch=2)
    ckpt.load_optimizer_jax_leaves(opt2, model2, "Adam", loaded["optimizer"],
                                   loaded["scheduler"]["opt_step"])
    step2 = steps.make_tracknet_train_step(model2, opt2, BG, alpha=0.0, schedule=sched2)

    # step 2 crosses the first StepLR boundary (every 1 epoch * 2 steps)
    assert sched2(2) == pytest.approx(1e-4)
    step(_batch(7), 2)
    step2(_batch(7), 2)
    for (k, a), (_, b) in zip(model.state_dict().items(), model2.state_dict().items()):
        assert torch.equal(a, b), k
