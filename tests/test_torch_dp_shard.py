"""Resident frames sharded over the entries of a CPU mesh
(``frame_sharding="shard"``) against the JAX loader's placement and against
the port's own replicated frames, on the synthetic dataset of
``test_torch_dp_train.py`` (128x72, 6 frames a rally) at ``input_hw=(32,
64)``, seq_len 3, batch 4.

- Each entry's rows equal the JAX buffer's ``addressable_shards[j].data``
  bit for bit, padding rows included, on 2 and 8 entries (the conftest's
  virtual CPU devices on the JAX side); the median stays whole on every
  entry.
- ``"auto"`` / ``"replicate"`` / ``"shard"`` resolve, or raise
  ``MemoryError``, as JAX's loader does over a few budgets on meshes of 1, 2
  and 8 entries and on one device.
- The exchange plan: unique rows sent once, a share whose rows all lie on
  its own entry gets nothing from the others, the order puts the rows back
  in window order, out-of-range rows raise.
- The assembled uint8 inputs of every share equal those of
  ``"replicate"`` over an epoch of shuffled batches, as do the eval step's
  on a short val batch (one receiver on the first entry), and one float32
  Adam step is bit-equal: loss, gradients, parameters.
- ``train(num_devices=2, resident_frames=True)`` with the loader's budget
  below the split logs ``shard over 2 devices`` and trains bit for bit as
  the replicated run.
"""

import functools
import shutil
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from test_torch_dp_train import _cfg, data_dir, float64_models  # noqa: E402,F401
from torch_dp_data import tracknet_model  # noqa: E402
from tracknetv3_tpu.data import dataset as jax_ds  # noqa: E402
from tracknetv3_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from tracknetv3_tpu_torch.data import dataset as ds  # noqa: E402
from tracknetv3_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh,
    plan_exchange,
    shard_train_batch,
)
from tracknetv3_tpu_torch.training import loop, optim, steps  # noqa: E402

SEQ, HW, B = 3, (32, 64), 4
KW = dict(batch_size=B, shuffle=True, drop_last=True, seed=3)


def _index(data_dir, split="train", step=1):  # noqa: F811
    return ds.build_split_index(data_dir, split, SEQ, step, input_hw=HW)


def _tensors(batch):
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v)
            for k, v in batch.items()}


def _jax_shards(arr):
    """A JAX array's addressable shards as numpy, in device order."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
    return [np.asarray(s.data) for s in shards]


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each test's checkpoints and save_dir (a full-width TrackNet checkpoint
    is 130 MB whatever input_hw) go once the test has read them."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("bg_mode,N", [("concat", 2), ("concat", 8), ("subtract", 8)])
def test_entries_hold_the_jax_addressable_shards(data_dir, bg_mode, N):  # noqa: F811
    idx = _index(data_dir)
    want = jax_ds.ResidentHeatmapLoader(idx, bg_mode, B, data_dir=data_dir,
                                        mesh=jax_make_mesh(N), frame_sharding="shard")
    got = ds.ResidentHeatmapLoader(idx, bg_mode, B, data_dir=data_dir,
                                   mesh=make_mesh(N, device="cpu"), frame_sharding="shard",
                                   device="cpu")
    assert got.frame_sharding == want.frame_sharding == "shard"
    T = len(np.concatenate([np.asarray(s) for s in _jax_shards(
        want.rgb_buf if want.rgb_buf is not None else want.diff_buf)]))
    assert T % N == 0 and T - got._n_frames < N  # padded to a multiple of N
    for name in ("rgb_buf", "diff_buf"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert isinstance(a, tuple) and len(a) == N
        for j, (mine, theirs) in enumerate(zip(a, _jax_shards(b))):
            assert mine.dtype == torch.uint8 and mine.shape == theirs.shape, (name, j)
            assert np.array_equal(mine.numpy(), theirs), (name, j)
    if bg_mode == "concat":  # whole on every entry
        for m in got.median_buf:
            assert np.array_equal(m.numpy(), np.asarray(want.median_buf))
    # the batches carry the global windows' rows and the plan's sizes
    for b_got, b_want in zip(got, want):
        np.testing.assert_array_equal(b_got["res_idx"], b_want["res_idx"])
        fs = b_got["res_shards"]
        assert fs.holders == N and fs.rows * N == T
        np.testing.assert_array_equal(fs.idx, b_want["res_idx"])


@pytest.mark.parametrize("N", [None, 1, 2, 8])
def test_frame_sharding_resolves_as_jax(data_dir, N):  # noqa: F811
    idx = _index(data_dir)
    total = ds.ResidentHeatmapLoader(idx, "concat", B, data_dir=data_dir,
                                     device="cpu").rgb_buf.numel()
    mesh_j = None if N is None else jax_make_mesh(N)
    mesh_p = None if N is None else make_mesh(N, device="cpu")
    seen = set()
    for budget in (2.0 * total, total, total - 1, total / 2, total / 8, total / 9):
        for mode in ("auto", "replicate", "shard"):
            out = []
            for mod, kw in ((jax_ds, dict(mesh=mesh_j)), (ds, dict(mesh=mesh_p, device="cpu"))):
                try:
                    out.append(mod.ResidentHeatmapLoader(
                        idx, "concat", B, data_dir=data_dir, budget_bytes=budget,
                        frame_sharding=mode, **kw).frame_sharding)
                except MemoryError as e:
                    out.append(("MemoryError", str(e)))
            assert out[0] == out[1], (budget, mode)
            seen.add(out[0] if isinstance(out[0], str) else out[0][0])
            if N is None:
                assert out[0] in ("single", ("MemoryError", out[0][1]))
    want = {None: {"single", "MemoryError"}, 1: {"replicate", "shard", "MemoryError"},
            2: {"replicate", "shard", "MemoryError"}, 8: {"replicate", "shard", "MemoryError"}}
    assert seen == want[N]


def test_the_exchange_plan():
    rows, holders = 5, 3  # holder j: rows [5 j, 5 j + 5)
    idx = np.array([[0, 1, 2], [1, 2, 3],      # receiver 0: all on holder 0
                    [4, 5, 14], [14, 14, 6]])  # receiver 1: holders 0, 1 and 2
    ex = plan_exchange(idx, rows, holders, 2)
    assert ex.received(0) == [4, 0, 0]  # nothing from the other holders
    assert ex.received(1) == [1, 2, 1]  # row 14 sent once
    assert ex.counts(0) == [4, 1] and ex.counts(2) == [0, 1]
    np.testing.assert_array_equal(ex.send[1][1], [0, 1])  # local rows of holder 1
    np.testing.assert_array_equal(ex.send[2][1], [4])
    for i, part in enumerate(np.split(idx, 2)):
        got = np.concatenate([ex.send[j][i] + j * rows for j in range(holders)])
        np.testing.assert_array_equal(got[ex.order[i]], part.reshape(-1))
        assert all(s.dtype == np.int32 for s in [ex.order[i]] + [ex.send[j][i]
                                                                 for j in range(holders)])
    with pytest.raises(IndexError):
        plan_exchange(idx, 4, holders, 2)  # row 14 beyond 3 x 4 rows
    with pytest.raises(ValueError):
        plan_exchange(idx, rows, holders, 3)


@functools.lru_cache(maxsize=None)
def _loaders(data_dir, N, bg_mode="concat"):  # noqa: F811
    """A CPU mesh of N entries and its train loaders under "shard" and
    "replicate", which draw the same batches."""
    mesh = make_mesh(N, device="cpu")
    return mesh, tuple(ds.ResidentHeatmapLoader(_index(data_dir), bg_mode, data_dir=data_dir,
                                                mesh=mesh, frame_sharding=mode, device="cpu",
                                                **KW)
                       for mode in ("shard", "replicate"))


def _share_inputs(batch, mesh, bg_mode):
    shares = shard_train_batch(_tensors(batch), mesh)
    frames = steps._Shares(mesh, None).frames(shares)
    return [steps.assemble_tracknet_inputs(b, bg_mode) for b in frames]


@pytest.mark.parametrize("bg_mode,N", [("concat", 2), ("concat", 4), ("subtract_concat", 4)])
def test_sharded_inputs_equal_the_replicated_for_every_share(data_dir, bg_mode, N):  # noqa: F811
    mesh, (shard, repl) = _loaders(data_dir, N, bg_mode)
    n = 0
    for b_s, b_r in zip(shard, repl, strict=True):
        assert "res_shards" in b_s and "res_shards" not in b_r
        got, want = _share_inputs(b_s, mesh, bg_mode), _share_inputs(b_r, mesh, bg_mode)
        assert len(got) == len(want) == N
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)
        n += 1
    assert n == len(repl) > 1
    # the eval step's path: a short batch, one receiver on the first entry
    kw = dict(batch_size=3, data_dir=data_dir, mesh=mesh, device="cpu")
    val = [ds.ResidentHeatmapLoader(_index(data_dir, "val", SEQ), bg_mode,
                                    frame_sharding=m, **kw) for m in ("shard", "replicate")]
    batches = [list(v) for v in val]
    assert len(batches[0]) > 0
    for b_s, b_r in zip(*batches, strict=True):
        assert torch.equal(steps.assemble_tracknet_inputs(_tensors(b_s), bg_mode),
                           steps.assemble_tracknet_inputs(_tensors(b_r), bg_mode))


def test_sharded_step_is_the_replicated_step_bit_for_bit(data_dir):  # noqa: F811
    mesh, (shard, repl) = _loaders(data_dir, 2)
    results = []
    for loader in (shard, repl):
        model = tracknet_model(seed=4, dtype=torch.float32)
        opt, sched = optim.build_optimizer("Adam", model.parameters(), 1e-3)
        step = steps.make_tracknet_shares_train_step(model, opt, "concat", 0.0, sched, mesh=mesh)
        loss = step(shard_train_batch(_tensors(next(iter(loader))), mesh), 0)
        results.append((loss, {k: (p.grad.clone(), p.detach().clone())
                               for k, p in model.named_parameters()}))
    (l_s, p_s), (l_r, p_r) = results
    assert torch.equal(l_s, l_r)
    for k in p_r:
        assert torch.equal(p_s[k][0], p_r[k][0]) and torch.equal(p_s[k][1], p_r[k][1]), k


def test_train_shards_above_the_budget_and_trains_as_replicated(data_dir, tmp_path):  # noqa: F811
    # the train split holds 24 frames, the val split 12: a budget of 3/5 of
    # the val split's bytes puts both above it and a quarter of each below
    val = ds.ResidentHeatmapLoader(_index(data_dir, "val", SEQ), "concat", B, data_dir=data_dir,
                                   device="cpu").rgb_buf.numel()
    train_bytes = val * 2
    assert ds.ResidentHeatmapLoader(_index(data_dir), "concat", B, data_dir=data_dir,
                                    device="cpu").rgb_buf.numel() == train_bytes
    runs, loaders = {}, []

    def placed(*args, **kw):
        loaders.append(ds.ResidentHeatmapLoader(*args, **kw, budget_bytes=budget))
        return loaders[-1]

    for name, budget in (("replicate", 6e9), ("shard", 0.6 * val)):
        logs = []
        with float64_models(), mock.patch.object(loop, "ResidentHeatmapLoader", placed):
            runs[name] = loop.train(_cfg(tmp_path / name, num_devices=4, epochs=1,
                                         resident_frames=True), data_dir, device="cpu",
                                    verbose_print=logs.append)
        placed_lines = [str(m) for m in logs if str(m).startswith("Resident frames")]
        assert placed_lines == [f"Resident frames: split staged to device memory ({name} over "
                                f"4 devices)"], logs
        assert not any("fallback" in str(m) for m in logs)
        # the train and the val split alike
        assert [ld.frame_sharding for ld in loaders[-2:]] == [name, name]
    got, want = runs["shard"], runs["replicate"]
    assert got["step"] == want["step"] > 0
    (g,), (w,) = got["history"], want["history"]
    assert (g["train_loss"], g["val_loss"], g["val_res"]) == (
        w["train_loss"], w["val_loss"], w["val_res"])
    sg, sw = got["model"].state_dict(), want["model"].state_dict()
    for k in sw:
        assert torch.equal(sg[k], sw[k]), k


def test_a_split_over_the_budget_on_one_device_still_falls_back(data_dir, tmp_path):  # noqa: F811
    logs = []
    placed = functools.partial(ds.ResidentHeatmapLoader, budget_bytes=1.0)
    with mock.patch.object(loop, "ResidentHeatmapLoader", placed):
        out = loop.train(_cfg(tmp_path, epochs=1, resident_frames=True), data_dir, device="cpu",
                         verbose_print=logs.append)
    assert out["step"] > 0
    assert any(str(m).startswith("resident_frames fallback: split frames") for m in logs)
    assert not any(str(m).startswith("Resident frames") for m in logs)
