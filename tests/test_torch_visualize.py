"""The port's ``utils/visualize.py`` and ``utils/images.py`` against the JAX
package's on the same seeded arrays.

- ``ScalarLogger`` + ``write_to_tb`` for a TrackNet and an InpaintNet
  epoch: ``scalars.jsonl`` equal byte for byte (and appended to by a second
  logger on the same dir), and the TensorBoard events read back with the
  same tags, steps and values.
- ``plot_heatmap_pred_sample``: every GIF frame equal pixel for pixel (RGB
  and grey input frames); ``plot_traj_pred_sample``, ``plot_diff_hist``
  and ``plot_median_files``: the PNGs equal pixel for pixel.
- ``to_img``, ``to_img_format`` equal; ``model_size_mb`` of the port's
  TrackNet equals the JAX package's of the same float32 variables.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores
from PIL import Image, ImageSequence  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.models import get_model as jax_get_model  # noqa: E402
from tracknetv3_tpu.utils import images as jax_images  # noqa: E402
from tracknetv3_tpu.utils import visualize as jax_vis  # noqa: E402
from tracknetv3_tpu_torch.models.convert import tracknet_from_jax  # noqa: E402
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402
from tracknetv3_tpu_torch.utils import images  # noqa: E402
from tracknetv3_tpu_torch.utils import visualize as vis  # noqa: E402

TRACKNET_RES = {"TP": 3.0, "TN": 1.0, "FP1": 2.0, "FP2": 0.0, "FN": 4.0,
                "accuracy": 0.4, "precision": 0.6, "recall": 0.42857142857142855,
                "f1": 0.5, "miss_rate": 0.5714285714285714}


def _inpaint_res(rng):
    return {t: {k: float(rng.random()) for k in TRACKNET_RES}
            for t in ("inpaint", "reconstruct", "baseline")}


def _log(module, log_dir, rng):
    """Two epochs of each model's scalars through ``module``'s logger."""
    logger = module.ScalarLogger(log_dir)
    for epoch in range(2):
        module.write_to_tb("TrackNet", logger, (float(rng.random()), float(rng.random())),
                           {k: np.float64(v + epoch) for k, v in TRACKNET_RES.items()}, epoch)
        module.write_to_tb("InpaintNet", logger, (float(rng.random()), 0.25),
                           _inpaint_res(rng), epoch)
    logger.close()


def _tb_scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_scalar_logger_and_write_to_tb_match_jax(tmp_path):
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    _log(vis, got, np.random.default_rng(0))
    _log(jax_vis, want, np.random.default_rng(0))
    with open(os.path.join(got, "scalars.jsonl"), "rb") as g, \
            open(os.path.join(want, "scalars.jsonl"), "rb") as w:
        got_bytes = g.read()
        assert got_bytes == w.read()
    lines = [json.loads(s) for s in got_bytes.decode().splitlines()]
    assert len(lines) == 2 * (2 + len(TRACKNET_RES) + 2 + 3 * len(TRACKNET_RES))
    assert {ln["tag"] for ln in lines} >= {"TrackNet/loss/train", "InpaintNet/val_inpaint/f1"}

    tb_got, tb_want = _tb_scalars(got), _tb_scalars(want)
    assert sorted(tb_got) == sorted(tb_want) and len(tb_got) == len(lines) // 2
    for tag, events in tb_want.items():
        assert tb_got[tag] == events, tag

    # a second logger on the same dir appends (a resumed run)
    _log(vis, got, np.random.default_rng(0))
    with open(os.path.join(got, "scalars.jsonl"), "rb") as g:
        assert g.read() == 2 * got_bytes


def _gif_frames(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


@pytest.mark.parametrize("grey", [False, True])
def test_heatmap_gif_matches_jax(tmp_path, grey):
    rng = np.random.default_rng(3)
    L, h, w = 3, 18, 32
    frame = rng.uniform(-0.1, 1.1, (L, h, w) if grey else (L, h, w, 3)).astype(np.float32)
    y_true = rng.random((L, h, w)).astype(np.float32)
    y_pred = rng.random((L, h, w)).astype(np.float32)
    vis.plot_heatmap_pred_sample(frame, y_true, y_pred, str(tmp_path / "port"))
    jax_vis.plot_heatmap_pred_sample(frame, y_true, y_pred, str(tmp_path / "jax"))
    got = _gif_frames(tmp_path / "port" / "cur_pred.gif")
    want = _gif_frames(tmp_path / "jax" / "cur_pred.gif")
    assert len(got) == len(want) == L
    for g, w_ in zip(got, want):
        assert g.shape == (h, 4 * w, 3)
        np.testing.assert_array_equal(g, w_)


def test_traj_and_hist_pngs_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    L = 16
    coor_gt = rng.random((L, 2)).astype(np.float32)
    coor_pred = rng.random((L, 2)).astype(np.float32)
    mask = (rng.random((L, 1)) < 0.4).astype(np.float32)
    vis.plot_traj_pred_sample(coor_gt, coor_pred, mask, str(tmp_path / "port"))
    jax_vis.plot_traj_pred_sample(coor_gt, coor_pred, mask, str(tmp_path / "jax"))
    np.testing.assert_array_equal(_png(tmp_path / "port" / "cur_traj.png"),
                                  _png(tmp_path / "jax" / "cur_traj.png"))

    args = (rng.integers(0, 5, 200).tolist(), rng.random(200) * 30,
            rng.integers(0, 5, 150).tolist(), rng.random(150) * 30)
    got = vis.plot_diff_hist(*args, labels=("a", "b"), save_dir=str(tmp_path / "port"))
    want = jax_vis.plot_diff_hist(*args, labels=("a", "b"), save_dir=str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want) == "error_hist.png"
    np.testing.assert_array_equal(_png(got), _png(want))


def test_median_previews_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    data = tmp_path / "data"
    for split, match in (("train", "match1"), ("train", "match2"), ("test", "match1")):
        os.makedirs(data / split / match)
        np.savez(data / split / match / "median.npz",
                 median=rng.uniform(0, 255, (18, 32, 3)).astype(np.float32))
    os.makedirs(data / "val" / "match9")  # no median: no preview
    vis.plot_median_files(str(data), str(tmp_path / "port"))
    jax_vis.plot_median_files(str(data), str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "test_match1.png", "train_match1.png", "train_match2.png"]
    for n in names:
        np.testing.assert_array_equal(_png(tmp_path / "port" / n), _png(tmp_path / "jax" / n))


def test_image_helpers_match_jax():
    rng = np.random.default_rng(6)
    x = rng.random((2, 4, 6, 12)).astype(np.float32)
    np.testing.assert_array_equal(images.to_img(x), jax_images.to_img(x))
    for num_ch in (1, 3, 4):
        got, want = images.to_img_format(x, num_ch), jax_images.to_img_format(x, num_ch)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    _, variables = jax_get_model("TrackNet", 3, "concat", rng=jax.random.PRNGKey(0),
                                 compute_dtype=jnp.float32)
    model = get_model("TrackNet", 3, "concat", dtype=torch.float32)
    model.load_state_dict(tracknet_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    assert images.model_size_mb(model) == jax_images.model_size_mb(variables) > 0
