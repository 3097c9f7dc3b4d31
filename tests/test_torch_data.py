"""The port's split index, frame cache and batch loader vs the JAX
package's, on a small synthetic dataset (``tools/make_synthetic_dataset.py``,
128x72, 24 frames) at ``input_hw=(32, 64)``.

Each package builds its own caches in its own copy of the dataset; the
indexes and every batch of two shuffled epochs must be equal, and
``window_channels`` must give the model input the JAX package gives.
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
    for kw in (dict(frame_alpha=0.5), dict(segment_windows=2), dict(process_count=2)):
        with pytest.raises(NotImplementedError):
            ds.HeatmapBatchLoader(idx, "concat", 4, **kw)
    with pytest.raises(NotImplementedError):
        ds.build_split_index(data_dirs["port"], "train", SEQ, 1, data_mode="coordinate")


def test_frame_cache_evicts_least_recent(data_dirs):
    idx = ds.build_split_index(data_dirs["port"], "train", SEQ, 1, input_hw=HW)
    cache = ds.FrameCache(data_dirs["port"], "concat", budget_bytes=1, input_hw=HW)
    for rd in idx.rally_dirs:
        rgb, diff, med = cache.load(rd)
        assert rgb.shape[1:] == HW + (3,) and diff is None and med.shape == HW + (3,)
    assert list(cache._rallies) == [idx.rally_dirs[-1]]  # one rally always stays
