"""The port's loaders in several processes against the JAX package's.

With ``process_id`` / ``process_count`` every process draws the global batch
order from the shared seed and assembles only its contiguous slice of each
batch's rows (of each batch's segments, for segmented batches). For process
counts 2 and 4 and every process id, each port loader's batches equal the
JAX loader's with the same arguments and seed, key for key and bit for bit,
over two shuffled epochs (so the generators move on alike): plain batches,
segmented ones, frame-mixup ones (each process plans its own rows from its
own generator), ``CoordinateBatchLoader``'s and ``iter_from``'s. The plain
slices put together give the one-process batch. Both packages refuse the
same configurations; resident frames over several processes stay refused.
The data is ``tools/make_synthetic_dataset.py``'s at ``input_hw=(32, 64)``.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from tracknetv3_tpu.data import dataset as jax_ds  # noqa: E402
from tracknetv3_tpu_torch.data import dataset as ds  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 64)
SEQ = 3
SLICES = [(2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)]  # (process_count, process_id)


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("synth")
    src = base / "src"
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "make_synthetic_dataset.py"),
         "--out", str(src), "--width", "128", "--height", "72", "--frames", "24"],
        check=True, capture_output=True, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    dirs = {}
    for name in ("jax", "port"):
        shutil.copytree(src, base / name)
        dirs[name] = str(base / name)
    return dirs


@pytest.fixture(scope="module")
def indexes(data_dirs):
    return (jax_ds.build_split_index(data_dirs["jax"], "train", SEQ, 1, input_hw=HW),
            ds.build_split_index(data_dirs["port"], "train", SEQ, 1, input_hw=HW))


def coordinate_index(n=38, L=8, seed=0):
    """A coordinate-mode index with seeded rows (the loaders read ``data``
    and ``input_hw`` only)."""
    rng = np.random.default_rng(seed)
    win = np.arange(n)[:, None] + np.arange(L)[None, :]
    data = {
        "id": np.stack([np.zeros_like(win), win], -1).astype(np.int32),
        "coor": rng.uniform(0, 500, (n, L, 2)).astype(np.float32),
        "coor_pred": rng.uniform(0, 500, (n, L, 2)).astype(np.float32),
        "vis": (rng.random((n, L)) < 0.8).astype(np.float32),
        "pred_vis": (rng.random((n, L)) < 0.7).astype(np.float32),
        "inpaint_mask": (rng.random((n, L)) < 0.2).astype(np.float32),
    }
    return ds.SplitIndex(data, ["rally"], np.ones((1, 2)), np.ones((1, 2)), (288, 512))


def _assert_batches_equal(got_batches, want_batches) -> int:
    n = 0
    for got, want in zip(got_batches, want_batches, strict=True):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n += 1
    return n


def _two_epochs(loader):
    return [b for _ in range(2) for b in loader]


def _pair(data_dirs, indexes, bg_mode, B, pc, pid, **kw):
    jidx, pidx = indexes
    return (ds.HeatmapBatchLoader(pidx, bg_mode, B, data_dir=data_dirs["port"], process_id=pid,
                                  process_count=pc, **kw),
            jax_ds.HeatmapBatchLoader(jidx, bg_mode, B, data_dir=data_dirs["jax"],
                                      process_id=pid, process_count=pc, **kw))


@pytest.mark.parametrize("pc,pid", SLICES)
def test_plain_batches_match_jax_and_make_up_the_global_batch(data_dirs, indexes, pc, pid):
    kw = dict(shuffle=True, drop_last=True, seed=5)
    got, want = _pair(data_dirs, indexes, "concat", 8, pc, pid, **kw)
    assert len(got) == len(want) > 1
    batches = _two_epochs(got)
    assert _assert_batches_equal(batches, _two_epochs(want)) == 2 * len(want)
    assert batches[0]["rgb"].shape[0] == 8 // pc
    # the slices of all processes, in process order, are the one-process batch
    whole = _two_epochs(ds.HeatmapBatchLoader(indexes[1], "concat", 8, data_dir=data_dirs["port"],
                                              **kw))
    parts = [_two_epochs(ds.HeatmapBatchLoader(indexes[1], "concat", 8,
                                               data_dir=data_dirs["port"], process_id=p,
                                               process_count=pc, **kw)) for p in range(pc)]
    assert len(whole) == len(batches)
    for i, one in enumerate(whole):
        for k in one:
            np.testing.assert_array_equal(np.concatenate([p[i][k] for p in parts]), one[k],
                                          err_msg=k)


@pytest.mark.parametrize("pc,pid", SLICES)
def test_segmented_batches_match_jax(data_dirs, indexes, pc, pid):
    got, want = _pair(data_dirs, indexes, "concat", 8, pc, pid, shuffle=True, drop_last=True,
                      seed=7, segment_windows=2)
    assert len(got) == len(want) > 1
    batches = _two_epochs(got)
    assert _assert_batches_equal(batches, _two_epochs(want)) == 2 * len(want)
    # 4 segments a batch: this process's 4 / pc, of 2 + SEQ - 1 frames each
    assert batches[0]["seg_rgb"].shape[:2] == (4 // pc, 2 + SEQ - 1)
    assert batches[0]["cxcy"].shape[0] == 8 // pc


@pytest.mark.parametrize("pc,pid", SLICES)
def test_frame_mixup_batches_match_jax(data_dirs, indexes, pc, pid):
    got, want = _pair(data_dirs, indexes, "subtract_concat", 8, pc, pid, shuffle=True,
                      drop_last=True, seed=11, frame_alpha=0.5)
    batches = _two_epochs(got)
    assert _assert_batches_equal(batches, _two_epochs(want)) == 2 * len(want)
    assert batches[0]["mix_pair"].shape == (8 // pc, SEQ, 2)
    # each process planned its own rows: its generator is the JAX one's, not
    # the one-process loader's
    one = ds.HeatmapBatchLoader(indexes[1], "subtract_concat", 8, data_dir=data_dirs["port"],
                                shuffle=True, drop_last=True, seed=11, frame_alpha=0.5)
    list(one)
    assert (got.rng.bit_generator.state == want.rng.bit_generator.state)
    assert (got.rng.bit_generator.state != one.rng.bit_generator.state) == (pc > 1)


@pytest.mark.parametrize("pc,pid", SLICES)
def test_coordinate_batches_match_jax(pc, pid):
    idx = coordinate_index()
    kw = dict(shuffle=True, drop_last=True, seed=13, process_id=pid, process_count=pc)
    got = ds.CoordinateBatchLoader(idx, 8, **kw)
    want = jax_ds.CoordinateBatchLoader(idx, 8, **kw)
    assert len(got) == len(want) == 4
    batches = _two_epochs(got)
    assert _assert_batches_equal(batches, _two_epochs(want)) == 8
    assert batches[0]["coor"].shape == (8 // pc, 8, 2)
    whole = _two_epochs(ds.CoordinateBatchLoader(idx, 8, shuffle=True, drop_last=True, seed=13))
    parts = [_two_epochs(ds.CoordinateBatchLoader(idx, 8, shuffle=True, drop_last=True, seed=13,
                                                  process_id=p, process_count=pc))
             for p in range(pc)]
    for i, one in enumerate(whole):
        for k in one:
            np.testing.assert_array_equal(np.concatenate([p[i][k] for p in parts]), one[k])


@pytest.mark.parametrize("pc,pid", [(2, 1), (4, 2)])
@pytest.mark.parametrize("kind", ["plain", "segmented", "coordinate"])
def test_iter_from_is_the_tail_and_matches_jax(data_dirs, indexes, kind, pc, pid):
    if kind == "coordinate":
        idx = coordinate_index()
        kw = dict(drop_last=True, process_id=pid, process_count=pc)
        got, want = ds.CoordinateBatchLoader(idx, 8, **kw), jax_ds.CoordinateBatchLoader(idx, 8,
                                                                                         **kw)
    else:
        seg = 2 if kind == "segmented" else 1
        got, want = _pair(data_dirs, indexes, "concat", 8, pc, pid, drop_last=True,
                          segment_windows=seg)
    full = list(got)
    tail = list(got.iter_from(2))
    assert len(full) >= 3 and len(tail) == len(full) - 2
    _assert_batches_equal(tail, full[2:])
    _assert_batches_equal(tail, want.iter_from(2))


def test_both_packages_refuse_the_same_configurations(data_dirs, indexes):
    jidx, pidx = indexes
    coord = coordinate_index()
    for mod, idx in ((ds, pidx), (jax_ds, jidx)):
        for B, drop_last in ((8, False), (6, True)):  # not full batches; 6 % 4 != 0
            with pytest.raises(AssertionError):
                mod.HeatmapBatchLoader(idx, "concat", B, drop_last=drop_last, process_count=4)
            with pytest.raises(AssertionError):
                mod.CoordinateBatchLoader(coord, B, drop_last=drop_last, process_count=4)
        # 3 segments a batch do not split over 2 processes: refused when iterated
        loader = mod.HeatmapBatchLoader(idx, "concat", 6, drop_last=True, segment_windows=2,
                                        process_count=2, data_dir=data_dirs["port"])
        with pytest.raises(AssertionError, match="segments per batch"):
            next(iter(loader))
    with pytest.raises(NotImplementedError, match="13b-ii"):
        ds.ResidentHeatmapLoader(pidx, "concat", 4, drop_last=True, process_count=2,
                                 data_dir=data_dirs["port"], device="cpu")
