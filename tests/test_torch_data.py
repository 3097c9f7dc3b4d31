"""The port's split index, frame cache and batch loader vs the JAX
package's, on a small synthetic dataset (``tools/make_synthetic_dataset.py``,
128x72, 24 frames) at ``input_hw=(32, 64)``.

Each package builds its own caches in its own copy of the dataset; the
indexes and every batch of two shuffled epochs must be equal, and
``window_channels`` must give the model input the JAX package gives. The
same holds key by key for segmented batches (with the short tail batch,
``iter_from`` and a label CSV that skips frames), frame-mixup batches and
the resident loader's index batches and device buffers.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.data import dataset as jax_ds  # noqa: E402
from tracknetv3_tpu.ops.preprocess import window_channels as jax_window_channels  # noqa: E402
from tracknetv3_tpu_torch.data import dataset as ds  # noqa: E402
from tracknetv3_tpu_torch.ops.preprocess import window_channels  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 64)
SEQ = 3


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


def _assert_index_equal(a, a_dir, b, b_dir):
    assert sorted(a.data) == sorted(b.data)
    for k in a.data:
        assert a.data[k].dtype == b.data[k].dtype, k
        np.testing.assert_array_equal(a.data[k], b.data[k], err_msg=k)
    np.testing.assert_array_equal(a.img_shape, b.img_shape)
    np.testing.assert_array_equal(a.img_scaler, b.img_scaler)
    assert tuple(a.input_hw) == tuple(b.input_hw)
    assert [os.path.relpath(d, a_dir) for d in a.rally_dirs] == [
        os.path.relpath(d, b_dir) for d in b.rally_dirs
    ]


@pytest.mark.parametrize("split,step", [("train", 1), ("val", SEQ)])
def test_split_index_matches_jax(data_dirs, split, step):
    want = jax_ds.build_split_index(data_dirs["jax"], split, SEQ, step, input_hw=HW)
    got = ds.build_split_index(data_dirs["port"], split, SEQ, step, input_hw=HW)
    _assert_index_equal(got, data_dirs["port"], want, data_dirs["jax"])
    # the port reads the cache files the JAX package wrote
    cross = ds.build_split_index(data_dirs["jax"], split, SEQ, step, input_hw=HW)
    _assert_index_equal(cross, data_dirs["jax"], want, data_dirs["jax"])


@pytest.mark.parametrize("bg_mode", ["concat", "", "subtract", "subtract_concat"])
def test_loader_batches_and_inputs_match_jax(data_dirs, bg_mode):
    kw = dict(shuffle=True, drop_last=True, seed=5)
    want_idx = jax_ds.build_split_index(data_dirs["jax"], "train", SEQ, 1, input_hw=HW)
    got_idx = ds.build_split_index(data_dirs["port"], "train", SEQ, 1, input_hw=HW)
    want_loader = jax_ds.HeatmapBatchLoader(want_idx, bg_mode, 4, data_dir=data_dirs["jax"], **kw)
    got_loader = ds.HeatmapBatchLoader(got_idx, bg_mode, 4, data_dir=data_dirs["port"], **kw)
    assert len(got_loader) == len(want_loader) > 0
    n = 0
    for _epoch in range(2):
        for got, want in zip(got_loader, want_loader, strict=True):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            n += 1
    assert n == 2 * len(want_loader)

    # model input of the last batch; XLA computes x / 255 as x * (1 / 255),
    # so the two differ by at most 1 ulp (6e-8 below 1)
    parts = [want.get(k) for k in ("rgb", "diff", "median")]
    want_x = jax_window_channels(*[None if p is None else jnp.asarray(p, jnp.float32)
                                   for p in parts], bg_mode)
    got_x = window_channels(*[None if p is None else torch.from_numpy(p).float()
                              for p in parts], bg_mode)
    assert got_x.shape == want_x.shape
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=6e-8, rtol=0)


def test_unported_loader_modes_raise(data_dirs):
    idx = ds.build_split_index(data_dirs["port"], "train", SEQ, 1, input_hw=HW)
    # several processes load as the JAX loaders do, with their checks: full
    # batches (drop_last) that the process count divides
    for mod in (ds, jax_ds):
        for B, kw in ((4, dict(process_count=2)), (6, dict(process_count=4, drop_last=True))):
            with pytest.raises(AssertionError):
                mod.HeatmapBatchLoader(idx, "concat", B, **kw)
            with pytest.raises(AssertionError):
                mod.CoordinateBatchLoader(idx, B, **kw)
    for kw in (dict(process_count=2), dict(mesh=object()), dict(frame_sharding="shard")):
        with pytest.raises(NotImplementedError):
            ds.ResidentHeatmapLoader(idx, "concat", 4, data_dir=data_dirs["port"], device="cpu",
                                     **kw)
    with pytest.raises(TypeError):  # the resident loader's device is the caller's to name
        ds.ResidentHeatmapLoader(idx, "concat", 4, data_dir=data_dirs["port"])
    with pytest.raises(ValueError):
        ds.build_split_index(data_dirs["port"], "train", SEQ, 1, data_mode="pixel")
    # as the JAX loader: segments take no frame mixup and must divide the batch
    for kw in (dict(segment_windows=2, frame_alpha=0.5), dict(segment_windows=3)):
        with pytest.raises(AssertionError):
            ds.HeatmapBatchLoader(idx, "concat", 4, **kw)
        with pytest.raises(AssertionError):
            jax_ds.HeatmapBatchLoader(idx, "concat", 4, **kw)


def _indexes(data_dirs, step=1):
    return (jax_ds.build_split_index(data_dirs["jax"], "train", SEQ, step, input_hw=HW),
            ds.build_split_index(data_dirs["port"], "train", SEQ, step, input_hw=HW))


def _assert_batches_equal(got_batches, want_batches):
    n = 0
    for got, want in zip(got_batches, want_batches, strict=True):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n += 1
    return n


@pytest.mark.parametrize("bg_mode", ["concat", "", "subtract_concat"])
@pytest.mark.parametrize("seg,B,drop_last", [(2, 8, True), (3, 9, False)])
def test_segmented_batches_match_jax(data_dirs, bg_mode, seg, B, drop_last):
    want_idx, got_idx = _indexes(data_dirs)
    kw = dict(shuffle=True, drop_last=drop_last, seed=7, segment_windows=seg)
    want_loader = jax_ds.HeatmapBatchLoader(want_idx, bg_mode, B, data_dir=data_dirs["jax"], **kw)
    got_loader = ds.HeatmapBatchLoader(got_idx, bg_mode, B, data_dir=data_dirs["port"], **kw)
    assert len(got_loader) == len(want_loader) > 0
    np.testing.assert_array_equal(got_loader._segment_starts, want_loader._segment_starts)
    batches = list(got_loader)
    assert _assert_batches_equal(batches, want_loader) == len(want_loader)
    assert _assert_batches_equal(got_loader, want_loader) == len(want_loader)  # second epoch
    key = "seg_diff" if bg_mode == "subtract" else "seg_rgb"
    assert batches[0][key].shape[:2] == (B // seg, seg + SEQ - 1)
    if not drop_last:  # the remaining segments form a short tail batch
        n_tail = len(got_loader._segment_starts) % (B // seg)
        assert n_tail and batches[-1][key].shape[0] == n_tail
        assert batches[-1]["cxcy"].shape[0] == n_tail * seg


@pytest.mark.parametrize("seg", [1, 2])
def test_iter_from_is_the_tail_and_matches_jax(data_dirs, seg):
    want_idx, got_idx = _indexes(data_dirs)
    want_loader = jax_ds.HeatmapBatchLoader(want_idx, "concat", 4, data_dir=data_dirs["jax"],
                                            segment_windows=seg)
    got_loader = ds.HeatmapBatchLoader(got_idx, "concat", 4, data_dir=data_dirs["port"],
                                       segment_windows=seg)
    full = list(got_loader)
    tail = list(got_loader.iter_from(2))
    assert len(full) >= 3 and len(tail) == len(full) - 2
    _assert_batches_equal(tail, full[2:])
    _assert_batches_equal(tail, want_loader.iter_from(2))
    shuffled = ds.HeatmapBatchLoader(got_idx, "concat", 4, shuffle=True,
                                     data_dir=data_dirs["port"], segment_windows=seg)
    with pytest.raises(AssertionError):
        next(shuffled.iter_from(1))


def test_segmented_loader_pairs_pixels_with_labels_across_frame_gaps(tmp_path):
    """A label CSV that skips an on-disk frame: each window of a segmented
    batch, expanded as the train step expands it, holds the pixels the plain
    loader pairs with it, each window at most twice an epoch, and the batches
    equal the JAX loader's."""
    import pandas as pd
    from PIL import Image

    from tracknetv3_tpu_torch.training.steps import assemble_tracknet_inputs

    root = tmp_path / "data"
    match = root / "train" / "match1"
    rally = "1_00_00"
    (match / "csv").mkdir(parents=True)
    fdir = match / "frame" / rally
    fdir.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for t in range(13):
        Image.fromarray(rng.integers(0, 255, size=(36, 64, 3), dtype=np.uint8)).save(
            fdir / f"{t}.png")
    labeled = [t for t in range(13) if t != 5]
    pd.DataFrame({"Frame": labeled, "Visibility": [1] * len(labeled),
                  "X": rng.integers(1, 63, len(labeled)),
                  "Y": rng.integers(1, 35, len(labeled))}).to_csv(
        match / "csv" / f"{rally}_ball.csv", index=False)
    idx = ds.build_split_index(str(root), "train", 4, 1, use_cache=False, input_hw=HW)
    jidx = jax_ds.build_split_index(str(root), "train", 4, 1, use_cache=False, input_hw=HW)

    def windows(loader):
        out, counts = {}, {}
        for b in loader:
            x = assemble_tracknet_inputs({k: torch.from_numpy(v) for k, v in b.items()}, "")
            for k in range(b["id"].shape[0]):
                key = tuple(b["id"][k].reshape(-1))
                out[key] = x[k].numpy()
                counts[key] = counts.get(key, 0) + 1
        return out, counts

    plain, _ = windows(ds.HeatmapBatchLoader(idx, "", 4, data_dir=str(root)))
    seg_loader = ds.HeatmapBatchLoader(idx, "", 4, data_dir=str(root), segment_windows=2)
    seg, counts = windows(seg_loader)
    assert set(seg) == set(plain) and max(counts.values()) <= 2
    for key in plain:
        np.testing.assert_array_equal(plain[key], seg[key])
    _assert_batches_equal(
        seg_loader, jax_ds.HeatmapBatchLoader(jidx, "", 4, data_dir=str(root), segment_windows=2))


@pytest.mark.parametrize("bg_mode,drop_last", [("concat", True), ("subtract_concat", False)])
def test_frame_mixup_batches_match_jax(data_dirs, bg_mode, drop_last):
    want_idx, got_idx = _indexes(data_dirs)
    kw = dict(shuffle=True, drop_last=drop_last, seed=11, frame_alpha=0.5)
    B = next(b for b in (8, 7, 6, 5) if len(got_idx) % b)  # the last batch is short
    want_loader = jax_ds.HeatmapBatchLoader(want_idx, bg_mode, B, data_dir=data_dirs["jax"], **kw)
    got_loader = ds.HeatmapBatchLoader(got_idx, bg_mode, B, data_dir=data_dirs["port"], **kw)
    batches = list(got_loader)
    assert _assert_batches_equal(batches, want_loader) == len(want_loader)
    _assert_batches_equal(got_loader, want_loader)  # the generator moved on alike
    b = batches[-1]
    nb = b["cxcy"].shape[0]
    assert (nb < B) == (not drop_last)  # the short last batch plans len(sel) windows
    assert b["mix_pair"].shape == (nb, SEQ, 2) and b["mix_pair"].dtype == np.int32
    assert b["mix_centers"].shape == (nb, SEQ, 2, 2) and b["mix_hm_w"].shape == (nb, SEQ)
    assert any((bb["mix_pix_w"] < 1).any() for bb in batches)  # some slot is a blend


@pytest.mark.parametrize("bg_mode", ["", "concat", "subtract"])
def test_resident_loader_matches_jax_and_the_plain_loader(data_dirs, bg_mode):
    from tracknetv3_tpu_torch.training.steps import assemble_tracknet_inputs

    want_idx, got_idx = _indexes(data_dirs, step=SEQ)
    kw = dict(shuffle=True, drop_last=False, seed=3)
    want_loader = jax_ds.ResidentHeatmapLoader(want_idx, bg_mode, 3, data_dir=data_dirs["jax"],
                                               **kw)
    got_loader = ds.ResidentHeatmapLoader(got_idx, bg_mode, 3, data_dir=data_dirs["port"],
                                          device="cpu", **kw)
    plain = ds.HeatmapBatchLoader(got_idx, bg_mode, 3, data_dir=data_dirs["port"], **kw)
    assert len(got_loader) == len(want_loader) == len(plain) > 0
    assert got_loader.frame_sharding == want_loader.frame_sharding == "single"
    for name in ("rgb_buf", "diff_buf", "median_buf"):
        a, b = getattr(got_loader, name), getattr(want_loader, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert str(a.dtype).split(".")[-1] == str(b.dtype), name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for got, want, std in zip(got_loader, want_loader, plain, strict=True):
        assert sorted(got) == sorted(want)
        for k in want:
            if k.endswith("_buf"):
                assert got[k] is getattr(got_loader, k[4:])  # the loader's one device tensor
                continue
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # the model input assembled from indices equals the pixel-shipping batch's
        x_res = assemble_tracknet_inputs(
            {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in got.items()}, bg_mode)
        x_std = assemble_tracknet_inputs({k: torch.from_numpy(v) for k, v in std.items()},
                                         bg_mode)
        assert torch.equal(x_res, x_std)


def test_resident_loader_budget(data_dirs):
    idx = ds.build_split_index(data_dirs["port"], "train", SEQ, SEQ, input_hw=HW)
    with pytest.raises(MemoryError, match="exceed the resident budget"):
        ds.ResidentHeatmapLoader(idx, "", 3, data_dir=data_dirs["port"], budget_bytes=10,
                                 device="cpu")
    with pytest.raises(MemoryError, match="exceed the resident budget"):
        jax_ds.ResidentHeatmapLoader(idx, "", 3, data_dir=data_dirs["port"], budget_bytes=10)


def test_resident_loader_refuses_an_index_outside_the_buffers(data_dirs):
    idx = ds.build_split_index(data_dirs["port"], "train", SEQ, SEQ, input_hw=HW)
    loader = ds.ResidentHeatmapLoader(idx, "", 3, data_dir=data_dirs["port"], device="cpu")
    loader._n_frames -= 1  # as if the last frame were missing from the buffer
    with pytest.raises(IndexError):
        list(loader)


def test_frame_cache_evicts_least_recent(data_dirs):
    idx = ds.build_split_index(data_dirs["port"], "train", SEQ, 1, input_hw=HW)
    cache = ds.FrameCache(data_dirs["port"], "concat", budget_bytes=1, input_hw=HW)
    for rd in idx.rally_dirs:
        rgb, diff, med = cache.load(rd)
        assert rgb.shape[1:] == HW + (3,) and diff is None and med.shape == HW + (3,)
    assert list(cache._rallies) == [idx.rally_dirs[-1]]  # one rally always stays
