"""The port's InpaintNet training against the JAX package's on the CPU, at
seq_len 8 and batch 4 on a small synthetic ``predicted_csv`` dataset.

- The coordinate-mode index (``build_split_index(data_mode="coordinate")``)
  and ``CoordinateBatchLoader`` batches (two shuffled epochs, and the
  unshuffled val loader) equal the JAX package's, array for array; the
  npz cache that one package writes, the other reads.
- ``masked_mse`` equals JAX's within 1e-7 relative.
- The optimizer's global-norm clip equals ``optax.clip_by_global_norm(1.0)``
  at gradient norms 0.5, 1.0 and 3.0, within 1e-7 relative (float64).
- One Adam step (clip 1.0) from one init, batch and mask: the JAX step draws
  the mask with ``jax.random.bernoulli`` under its key; the test draws the
  same mask under that key and hands it to the port's step. Loss, every
  gradient and every parameter within 1e-10 relative L2 in float64; in
  float32 the loss and every gradient within 1e-5, and the parameters as
  one vector (see the test for why not each bias alone). The JAX
  package computes its loss and its sigmoid in float32 whatever the input;
  for the float64 run the test points ``jnp.float32`` at float64 while the
  JAX step traces, so that both sides compute the same function in float64.
- The eval step's loss and ``coor_inpaint`` (float64, the same way), and
  ``eval_inpaintnet``'s three confusions on a batch with ``COOR_TH``
  zeroings and repeated ids, equal the JAX package's.
- One ``train()`` epoch resumes from a checkpoint written by either package,
  with the Adam state and the StepLR count carried across.
"""

import csv
import os
import shutil
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from PIL import Image  # noqa: E402

from tracknetv3_tpu.data import dataset as jax_ds  # noqa: E402
from tracknetv3_tpu.evaluation import loops as jax_loops  # noqa: E402
from tracknetv3_tpu.models import get_model as jax_get_model  # noqa: E402
from tracknetv3_tpu.models.inpaintnet import InpaintNet as JaxInpaintNet  # noqa: E402
from tracknetv3_tpu.ops.losses import masked_mse as jax_masked_mse  # noqa: E402
from tracknetv3_tpu.training import checkpoint as jax_ckpt  # noqa: E402
from tracknetv3_tpu.training import optim as jax_optim  # noqa: E402
from tracknetv3_tpu.training import steps as jax_steps  # noqa: E402
from tracknetv3_tpu_torch.config import COOR_TH, TrainConfig  # noqa: E402
from tracknetv3_tpu_torch.data import dataset as ds  # noqa: E402
from tracknetv3_tpu_torch.evaluation.loops import eval_inpaintnet  # noqa: E402
from tracknetv3_tpu_torch.models.convert import (  # noqa: E402
    INPAINT_PARAM_MAP,
    conv1d_to_torch_layout,
    inpaintnet_from_jax,
    inpaintnet_to_jax,
)
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402
from tracknetv3_tpu_torch.ops.losses import masked_mse  # noqa: E402
from tracknetv3_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from tracknetv3_tpu_torch.training import loop, optim, steps  # noqa: E402

SEQ, B, T = 8, 4, 20  # window, batch, frames per rally
COLUMNS = ["Frame", "Visibility_GT", "X_GT", "Y_GT", "Visibility", "X", "Y", "Inpaint_Mask"]


def _write_rally(match_dir, rally, rng, reverse=False, blank=False):
    """A 20-frame rally: a frame for the geometry and its predicted_csv: a
    visible arc with an occlusion, the prediction off by seeded noise (to
    0.1 px), dropped detections and an inpaint mask over the gaps."""
    frame_dir = os.path.join(match_dir, "frame", rally)
    os.makedirs(frame_dir, exist_ok=True)
    Image.fromarray(np.zeros((36, 64, 3), np.uint8)).save(os.path.join(frame_dir, "0.png"))
    rows = []
    for t in range(T):
        vis_gt = int(not 6 <= t < 8)
        x_gt = int(40 + 20 * t) * vis_gt
        y_gt = int(200 - 8 * t + t * t // 2) * vis_gt
        vis = int(vis_gt and rng.random() > 0.25)
        x = round(x_gt + rng.normal(0, 3), 1) if vis else 0
        y = round(y_gt + rng.normal(0, 3), 1) if vis else 0
        rows.append([t, vis_gt, x_gt, y_gt, vis, x, y, int(vis_gt and not vis)])
    if blank:
        rows[3][6] = ""  # a blank field reads as 0
    os.makedirs(os.path.join(match_dir, "predicted_csv"), exist_ok=True)
    with open(os.path.join(match_dir, "predicted_csv", f"{rally}_ball.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(COLUMNS)
        w.writerows(rows[::-1] if reverse else rows)  # the readers sort by Frame


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coord") / "data")
    rng = np.random.default_rng(0)
    for split, matches in (("train", (1, 2)), ("val", (1,))):
        for m in matches:
            for r, rally in enumerate(("1_01_00", "1_02_00")):
                _write_rally(os.path.join(root, split, f"match{m}"), rally, rng,
                             reverse=(m, r) == (2, 1), blank=(m, r) == (1, 0))
    return root


def _copy(data_dir, tmp_path, name):
    out = str(tmp_path / name)
    shutil.copytree(data_dir, out)
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each test's checkpoints and save_dir (a full-width TrackNet checkpoint
    is 130 MB whatever input_hw) go once the test has read them."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("split,stride", [("train", 1), ("val", SEQ)])
def test_coordinate_index_and_loader_match_jax(data_dir, tmp_path, split, stride):
    want = jax_ds.build_split_index(data_dir, split, SEQ, stride, "coordinate", use_cache=False)
    got = ds.build_split_index(data_dir, split, SEQ, stride, "coordinate", use_cache=False)
    assert sorted(got.data) == sorted(want.data) and len(got) == len(want) > 0
    for k in want.data:
        assert got.data[k].dtype == want.data[k].dtype, k
        np.testing.assert_array_equal(got.data[k], want.data[k], err_msg=k)
    assert got.input_hw == tuple(want.input_hw)

    shuffled = dict(shuffle=True, drop_last=True, seed=7)
    for kw in (shuffled, {}):
        jl = jax_ds.CoordinateBatchLoader(want, B, **kw)
        pl = ds.CoordinateBatchLoader(got, B, **kw)
        assert len(pl) == len(jl)
        for _ in range(2):  # two epochs of one loader: the generator's stream
            _assert_batches_equal(list(pl), list(jl))

    # the cache carries the mode; a port cache serves the JAX package
    d = _copy(data_dir, tmp_path, "cached")
    ds.build_split_index(d, split, SEQ, stride, "coordinate")
    assert os.path.exists(os.path.join(d, f"data_l{SEQ}_s{stride}_coordinate_{split}.npz"))
    cached = jax_ds.build_split_index(d, split, SEQ, stride, "coordinate")
    for k in want.data:
        np.testing.assert_array_equal(cached.data[k], want.data[k], err_msg=k)


def test_masked_mse_matches_jax():
    rng = np.random.default_rng(1)
    pred, target = rng.uniform(0, 1, (2, B, 16, 2)).astype(np.float32)
    mask = (rng.random((B, 16, 1)) < 0.3).astype(np.float32)
    want = float(jax_masked_mse(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask)))
    got = masked_mse(*(torch.from_numpy(a) for a in (pred, target, mask)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-7)


@pytest.mark.parametrize("norm", [0.5, 1.0, 3.0])
def test_clip_matches_optax(norm):
    rng = np.random.default_rng(int(norm * 10))
    grads = [rng.normal(size=s) for s in ((3, 5), (7,), (2, 2, 4))]
    scale = norm / np.sqrt(sum((g ** 2).sum() for g in grads))
    grads = [g * scale for g in grads]
    with jax.enable_x64(True):
        clip = optax.clip_by_global_norm(1.0)
        want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
        want = [np.asarray(w) for w in want]
    got = [torch.from_numpy(g.copy()) for g in grads]
    optim.clip_by_global_norm_(got, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-7, atol=0)
    if norm < 1.0:  # under the max norm the gradients are left as they are
        for g, g0 in zip(got, grads):
            np.testing.assert_array_equal(g.numpy(), g0)

    # the optimizer clips before its update, as optax.chain(clip, sgd) does
    # (SGD's first step moves by the gradient itself: not scale-free as Adam's)
    params = [torch.nn.Parameter(torch.ones(g.shape, dtype=torch.float64)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    opt, _ = optim.build_optimizer("SGD", params, 1.0, clip_norm=1.0)
    opt.step()
    with jax.enable_x64(True):
        tx = jax_optim.build_optimizer("SGD", 1.0, clip_norm=1.0)
        ones = [jnp.ones(g.shape) for g in grads]
        upd, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(ones), ones)
        want = [np.asarray(w) for w in optax.apply_updates(ones, upd)]
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-7, atol=0)


# ------------------------------------------------------------ the steps


@pytest.fixture(scope="module")
def init_params():
    _, variables = jax_get_model("InpaintNet", 16, rng=jax.random.PRNGKey(5))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _batch(seed=2):
    """coor_pred near coor (the loss then pulls the network hard: gradient
    norm above the clip's 1.0), vis with gaps."""
    rng = np.random.default_rng(seed)
    coor = rng.uniform(0.1, 0.9, (B, 16, 2))
    return {
        "coor": coor,
        "coor_pred": np.clip(coor + rng.normal(0, 0.02, coor.shape), 0, 1),
        "vis": (rng.random((B, 16, 1)) < 0.8).astype(np.float64),
        "inpaint_mask": (rng.random((B, 16, 1)) < 0.3).astype(np.float64),
        "id": np.stack([np.zeros((B, 16), int), np.arange(16)[None].repeat(B, 0)],
                       -1).astype(np.int32),
    }


def _jax_context(dtype):
    """x64 for float64, with the JAX package's float32 casts pointed at float64."""
    if dtype == "float32":
        return jax.enable_x64(False), mock.patch.object(jnp, "float32", jnp.float32)
    return jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64)


def _port_model(init_params, dtype):
    model = get_model("InpaintNet")
    model.load_state_dict(inpaintnet_from_jax({"params": init_params}))
    return model.to(getattr(torch, dtype))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("dtype,bound", [("float64", 1e-10), ("float32", 1e-5)])
def test_train_step_matches_jax(init_params, dtype, bound):
    batch = _batch()
    key = jax.random.PRNGKey(3)
    x64, cast = _jax_context(dtype)
    with x64, cast:
        jdt = jnp.float64 if dtype == "float64" else jnp.float32
        model = JaxInpaintNet(dtype=jdt)
        tx = jax_optim.build_optimizer("Adam", 1e-3, clip_norm=1.0)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), init_params)
        state = jax_steps.create_train_state({"params": params}, tx)
        jb = {k: jnp.asarray(v, jdt) for k, v in batch.items() if k != "id"}
        # the mask the step draws from its key
        mask = np.asarray(jax.random.bernoulli(key, 0.3, jb["vis"].shape), np.float64)
        m = (jb["vis"] > 0) * jnp.asarray(mask, jdt)
        jgrads = jax.grad(lambda p: jax_masked_mse(
            model.apply({"params": p}, jb["coor_pred"] * (1 - m), m), jb["coor"], m))(params)
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
        new_state, jloss = jax_steps.make_inpaintnet_train_step(model, tx, 0.3)(state, jb, key)
        want = jax.tree_util.tree_map(np.asarray, new_state.params)
        jloss = float(jloss)
    assert 0 < mask.sum() < mask.size

    tdt = getattr(torch, dtype)
    port = _port_model(init_params, dtype)
    opt, sched = optim.build_optimizer("Adam", port.parameters(), 1e-3, clip_norm=1.0)
    step = steps.make_inpaintnet_train_step(port, opt, sched)
    tb = {k: torch.from_numpy(v).to(tdt) for k, v in batch.items() if k != "id"}
    loss = step(tb, 0, torch.from_numpy(mask).to(tdt))
    assert loss.dtype == tdt
    assert abs(float(loss) - jloss) <= bound * abs(jloss)
    got = inpaintnet_to_jax(port)["params"]
    grads = inpaintnet_to_jax({n: p.grad for n, p in port.named_parameters()})["params"]

    def leaf(tree, path):
        for p in path:
            tree = tree[p]
        return np.asarray(tree, np.float64)

    for path, _ in INPAINT_PARAM_MAP:  # the gradients (the clip does not act here)
        assert _rel_l2(leaf(grads, path), leaf(jgrads, path)) <= bound, path
    if dtype == "float64":
        for path, _ in INPAINT_PARAM_MAP:
            assert _rel_l2(leaf(got, path), leaf(want, path)) <= bound, path
    else:
        # float32: Adam's first step moves a zero-initialised bias by
        # lr * g / (|g| + eps), so float32 rounding of a gradient element
        # near 0 moves a whole element of such a bias: the parameters are
        # held as one vector, the gradients each
        flat = [np.concatenate([leaf(t, path).ravel() for path, _ in INPAINT_PARAM_MAP])
                for t in (got, want)]
        assert _rel_l2(*flat) <= bound


def test_eval_step_and_confusion_match_jax(init_params):
    batch = _batch(seed=4)
    # points under COOR_TH in both coordinates where nothing is inpainted:
    # the composite keeps them and the eval zeroes them
    batch["coor_pred"][0, :5] = 0.5 * COOR_TH
    batch["inpaint_mask"][0, :5] = 0.0
    batch["coor_pred"][1, 3] = (0.2, 0.5 * COOR_TH)  # only one coordinate under: kept
    batch["inpaint_mask"][1, 3] = 0.0
    # repeated ids at the end of two windows (padding): the confusions count
    # each frame once
    batch["id"][2, -3:] = batch["id"][2, -4]
    batch["id"][3, -1] = batch["id"][3, -2]
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        model = JaxInpaintNet(dtype=jnp.float64)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), init_params)
        state = jax_steps.create_train_state({"params": params}, optax.adam(1e-3))
        jstep = jax_steps.make_inpaintnet_eval_step(model)
        jb = {k: (v if k == "id" else jnp.asarray(v)) for k, v in batch.items()}
        jloss, jcoor = jstep(state, jb)
        jloss, jcoor = float(jloss), np.asarray(jcoor)
        jval = jax_loops.eval_inpaintnet(state, jstep, [jb, jb], input_hw=(288, 512))
    assert (jcoor[0, :5] == 0).all() and (jcoor[1, 3] != 0).all()

    port = _port_model(init_params, "float64")
    step = steps.make_inpaintnet_eval_step(port)
    tb = {k: (v if k == "id" else torch.from_numpy(v)) for k, v in batch.items()}
    loss, coor = step(tb)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-12)
    np.testing.assert_allclose(coor.numpy(), jcoor, rtol=1e-12, atol=1e-15)
    assert (coor.numpy()[0, :5] == 0).all()
    val_loss, res = eval_inpaintnet(step, [tb, tb], input_hw=(288, 512))
    np.testing.assert_allclose(val_loss, jval[0], rtol=1e-12)
    assert res == jval[1]
    # the repeated ids were dropped: 4 windows x 16 frames less 4, twice
    counts = [res[t][k] for t in res for k in ("TP", "TN", "FP1", "FP2", "FN")]
    assert sum(counts) == 3 * 2 * (4 * 16 - 4)


# ------------------------------------------------------------ train() and resume


def _cfg(save_dir, **kw):
    base = dict(model_name="InpaintNet", seq_len=SEQ, batch_size=B, epochs=1,
                lr_scheduler="StepLR", mask_ratio=0.3, save_dir=str(save_dir))
    base.update(kw)
    return TrainConfig(**base)


def _jax_tx(steps_per_epoch, epochs):
    return jax_optim.build_optimizer("Adam", 1e-3, "StepLR", epochs=epochs,
                                     steps_per_epoch=steps_per_epoch, clip_norm=1.0)


def test_train_resumes_from_a_port_checkpoint(data_dir, tmp_path):
    logs = []
    out = loop.train(_cfg(tmp_path), data_dir, device="cpu", verbose_print=logs.append)
    (h,) = out["history"]
    spe = out["step"]
    assert spe == len(ds.CoordinateBatchLoader(
        ds.build_split_index(data_dir, "train", SEQ, 1, "coordinate"), B, drop_last=True)) > 0
    assert np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
    assert sorted(h["val_res"]) == ["baseline", "inpaint", "reconstruct"]
    for name in ("InpaintNet_best.pt", "InpaintNet_cur.pt"):
        assert os.path.exists(tmp_path / name)

    # the port's optimizer leaves are the state of the JAX package's
    # chain(clip_by_global_norm, adam, StepLR)
    saved = jax_ckpt.load_checkpoint(str(tmp_path / "InpaintNet_cur.pt"))
    assert saved["param_dict"]["model_name"] == "InpaintNet"
    ref = _jax_tx(spe, 1).init(saved["model"]["params"])
    restored = jax_ckpt.unflatten_optimizer_state(ref, saved["optimizer"])
    ref_leaves, got_leaves = jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(restored)
    assert [np.shape(a) for a in got_leaves] == [np.shape(a) for a in ref_leaves]
    assert int(got_leaves[0]) == spe and int(got_leaves[-1]) == spe  # Adam's and StepLR's counts
    # mu in the flax layout: the port's exp_avg of the same parameter
    port_leaves = ckpt.load_checkpoint(str(tmp_path / "InpaintNet_cur.pt"))["optimizer"]
    names = [n for _, n in INPAINT_PARAM_MAP]
    np.testing.assert_array_equal(np.asarray(restored[1][0].mu["down_1"]["conv"]["kernel"]),
                                  port_leaves[1 + names.index("down_1.conv.weight")])

    out2 = loop.train(_cfg(tmp_path, epochs=2, resume_training=True, batch_size=3),
                      data_dir, device="cpu", verbose_print=logs.append)
    assert [h["epoch"] for h in out2["history"]] == [1] and out2["step"] == 2 * spe
    assert any("Resume training from epoch 1" in str(m) for m in logs)
    leaves = ckpt.load_checkpoint(str(tmp_path / "InpaintNet_cur.pt"))["optimizer"]
    assert int(leaves[0]) == int(leaves[-1]) == 2 * spe


def test_train_resumes_from_a_jax_checkpoint(data_dir, tmp_path, init_params):
    index = jax_ds.build_split_index(data_dir, "train", SEQ, 1, "coordinate")
    batches = list(jax_ds.CoordinateBatchLoader(index, B, shuffle=True, drop_last=True, seed=13))
    spe = len(batches)
    tx = _jax_tx(spe, 1)
    state = jax_steps.create_train_state({"params": init_params}, tx)
    jstep = jax_steps.make_inpaintnet_train_step(JaxInpaintNet(), tx, 0.3)
    key = jax.random.PRNGKey(13)
    for i, b in enumerate(batches):
        state, _ = jstep(state, {k: v for k, v in b.items() if k != "id"},
                         jax.random.fold_in(key, i))
    jax_ckpt.save_checkpoint(
        str(tmp_path / "InpaintNet_cur.pt"), epoch=0, max_val_acc=0.0,
        model={"params": state.params, "batch_stats": {}}, optimizer=state.opt_state,
        scheduler=dict(lr_scheduler="StepLR", opt_step=spe),
        param_dict=_cfg(tmp_path).to_param_dict())
    jax_mu = jax.tree_util.tree_map(np.asarray, state.opt_state[1][0].mu)

    loaded = {}

    def recording(optimizer, model, optim_name, leaves, step):
        ckpt.load_optimizer_jax_leaves(optimizer, model, optim_name, leaves, step)
        params = dict(model.named_parameters())
        loaded.update(step=step, mu={n: optimizer.state[params[n]]["exp_avg"].numpy().copy()
                                     for _, n in INPAINT_PARAM_MAP})

    with mock.patch.object(loop, "load_optimizer_jax_leaves", recording):
        out = loop.train(_cfg(tmp_path, epochs=2, resume_training=True), data_dir,
                         device="cpu", verbose_print=str)
    assert loaded["step"] == spe and out["step"] == 2 * spe
    assert [h["epoch"] for h in out["history"]] == [1]
    for path, name in INPAINT_PARAM_MAP:
        w = jax_mu
        for p in path:
            w = w[p]
        np.testing.assert_array_equal(loaded["mu"][name], conv1d_to_torch_layout(w))
