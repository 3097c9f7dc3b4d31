"""The port's training loop logs and samples as the JAX loop does, on the CPU
at ``input_hw=(32, 64)``, seq_len 3, on a small synthetic dataset.

- A ``debug`` TrackNet epoch, and an InpaintNet epoch, then a resumed one:
  ``save_dir/logs/scalars.jsonl`` equals, byte for byte, what the JAX
  package's ``ScalarLogger`` + ``write_to_tb`` write for the returned
  ``history`` (so the tags, steps and values are JAX's layout and the
  returned numbers), the resumed run appends to it, and the progress
  sample (``cur_pred.gif`` / ``cur_traj.png``) is written every
  ``display_step`` = 4 steps.
- ``visualize_step`` against the JAX loop's: the JAX ``train`` runs with
  its train step replaced by one that keeps the state (no train-step
  compile) and its eval step in float32; at each sample the state and
  batch it plotted are handed, converted, to the port's ``visualize_step``,
  whose plot arrays must match: the frames and label maps exactly, the
  probabilities within the float32 forward bound of
  ``tests/test_torch_fused_forward.py`` (max 1e-5, mean 1e-6); InpaintNet's
  coordinates within 1e-5. Plain ``rgb`` / ``diff`` and segmented
  ``seg_rgb`` / ``seg_diff`` batches.
- A missing PIL prints ``(viz skipped: ...)``, as does a resident batch; an
  eval step that raises propagates. The loop's ``SampleWriter`` draws a
  sample on its thread and re-raises a drawing error at ``wait`` or at the
  next sample.
"""

import csv
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.config import TrainConfig as JaxTrainConfig  # noqa: E402
from tracknetv3_tpu.evaluation.metrics import metrics_dict as jax_metrics_dict  # noqa: E402
from tracknetv3_tpu.models.fused_forward import tracknet_train_forward  # noqa: E402
from tracknetv3_tpu.ops.losses import wbce as jax_wbce  # noqa: E402
from tracknetv3_tpu.training import loop as jax_loop  # noqa: E402
from tracknetv3_tpu.training import steps as jax_steps  # noqa: E402
from tracknetv3_tpu.utils import visualize as jax_vis  # noqa: E402
from tracknetv3_tpu_torch.config import TrainConfig  # noqa: E402
from tracknetv3_tpu_torch.models.convert import inpaintnet_from_jax, tracknet_from_jax  # noqa: E402
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402
from tracknetv3_tpu_torch.training import loop  # noqa: E402
from tracknetv3_tpu_torch.training import steps  # noqa: E402
from tracknetv3_tpu_torch.utils import visualize as vis  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, HW = 3, (32, 64)
PRED_COLUMNS = ["Frame", "Visibility_GT", "X_GT", "Y_GT", "Visibility", "X", "Y",
                "Inpaint_Mask"]


def _write_predicted_csvs(root, rng):
    """``predicted_csv`` for every train / val rally from its label CSV: the
    label off by seeded noise, a quarter of the visible frames missed and
    masked for inpainting."""
    for split in ("train", "val"):
        for match in sorted(os.listdir(os.path.join(root, split))):
            match_dir = os.path.join(root, split, match)
            os.makedirs(os.path.join(match_dir, "predicted_csv"), exist_ok=True)
            for name in sorted(os.listdir(os.path.join(match_dir, "csv"))):
                with open(os.path.join(match_dir, "csv", name), newline="") as f:
                    rows = list(csv.DictReader(f))
                out = []
                for r in rows:
                    vis_gt, x, y = int(r["Visibility"]), float(r["X"]), float(r["Y"])
                    hit = vis_gt and rng.random() > 0.25
                    px, py = (round(x + rng.normal(0, 2), 1), round(y + rng.normal(0, 2), 1)) \
                        if hit else (0, 0)
                    out.append([r["Frame"], vis_gt, x, y, int(hit), px, py,
                                int(vis_gt and not hit)])
                with open(os.path.join(match_dir, "predicted_csv", name), "w",
                          newline="") as f:
                    w = csv.writer(f)
                    w.writerow(PRED_COLUMNS)
                    w.writerows(out)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth") / "data"
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "make_synthetic_dataset.py"),
         "--out", str(out), "--width", "128", "--height", "72", "--frames", "12"],
        check=True, capture_output=True, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    _write_predicted_csvs(str(out), np.random.default_rng(0))
    return str(out)


def _copy(data_dir, tmp_path, name):
    out = str(tmp_path / name)
    shutil.copytree(data_dir, out)
    return out


def _jax_jsonl(history, model_name, log_dir):
    """What the JAX loop's logger writes for ``history``."""
    logger = jax_vis.ScalarLogger(log_dir)
    for h in history:
        jax_vis.write_to_tb(model_name, logger, (h["train_loss"], h["val_loss"]),
                            h["val_res"], h["epoch"])
    logger.close()
    with open(os.path.join(log_dir, "scalars.jsonl"), "rb") as f:
        return f.read()


def _port_jsonl(save_dir):
    with open(os.path.join(save_dir, "logs", "scalars.jsonl"), "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each test's checkpoints and save_dir (a full-width TrackNet checkpoint
    is 130 MB whatever input_hw) go once the test has read them."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_tracknet_debug_epoch_logs(data_dir, tmp_path):
    save = tmp_path / "exp"
    cfg = TrainConfig(seq_len=SEQ, bg_mode="concat", batch_size=8, alpha=0.5, input_hw=HW,
                      compute_dtype="float32", save_dir=str(save), debug=True, epochs=1)
    logs = []
    out = loop.train(cfg, _copy(data_dir, tmp_path, "d"), device="cpu",
                     verbose_print=logs.append)
    assert out["step"] == 5  # 40 windows / 8: a sample after step 4
    assert os.path.getsize(save / "cur_pred.gif") > 0
    got = _port_jsonl(save)
    assert got == _jax_jsonl(out["history"], "TrackNet", str(tmp_path / "j"))
    assert b'"TrackNet/val/f1"' in got
    assert not any("viz skipped" in str(m) for m in logs)


def test_inpaintnet_debug_epoch_logs_then_resume_appends(data_dir, tmp_path):
    save = tmp_path / "exp"
    cfg = dict(model_name="InpaintNet", seq_len=4, batch_size=4, save_dir=str(save),
               debug=True, lr_scheduler="StepLR")
    data = _copy(data_dir, tmp_path, "d")
    out1 = loop.train(TrainConfig(epochs=1, **cfg), data, device="cpu", verbose_print=str)
    assert out1["step"] >= 4
    assert os.path.getsize(save / "cur_traj.png") > 0
    first = _port_jsonl(save)
    assert first == _jax_jsonl(out1["history"], "InpaintNet", str(tmp_path / "j1"))
    assert b'"InpaintNet/val_inpaint/accuracy"' in first

    os.remove(save / "cur_traj.png")
    out2 = loop.train(TrainConfig(epochs=2, resume_training=True, **cfg), data,
                      device="cpu", verbose_print=str)
    assert [h["epoch"] for h in out2["history"]] == [1]
    both = _port_jsonl(save)
    assert both.startswith(first) and len(both) > len(first)
    assert both == _jax_jsonl(out1["history"] + out2["history"], "InpaintNet",
                              str(tmp_path / "j2"))
    assert os.path.exists(save / "cur_traj.png")


def _f32_eval_step(bg_mode):
    """The JAX eval step (``steps.make_tracknet_eval_step``) in float32."""

    @jax.jit
    def step(state, batch):
        x, y = jax_steps.assemble_tracknet_batch(batch, bg_mode)
        logits, _ = tracknet_train_forward(state.params, state.batch_stats, x, train=False,
                                           dtype=jnp.float32)
        probs = jax.nn.sigmoid(logits)
        return jax_wbce(probs, y), probs

    return step


def _run_jax_samples(monkeypatch, model_name, data_dir, save_dir, **cfg):
    """The JAX ``train`` for one debug epoch with a train step that keeps the
    state and validation stubbed out; returns, per progress sample, the
    (state, batch) that its ``visualize_step`` evaluated and the arrays it
    handed to the plot."""
    calls, samples = [], []

    def recording(make):
        def factory(*a, **k):
            inner = make(*a, **k)

            def step(state, batch):
                calls.append((state, batch))
                return inner(state, batch)

            return step

        return factory

    keep = lambda *a, **k: (lambda state, batch, rng: (state, jnp.float32(0.0)))  # noqa: E731
    monkeypatch.setattr(jax_loop, "make_tracknet_train_step", keep)
    monkeypatch.setattr(jax_loop, "make_inpaintnet_train_step", keep)
    monkeypatch.setattr(jax_loop, "make_tracknet_eval_step",
                        recording(lambda bg_mode: _f32_eval_step(bg_mode)))
    monkeypatch.setattr(jax_loop, "make_inpaintnet_eval_step",
                        recording(jax_steps.make_inpaintnet_eval_step))
    zeros = jax_metrics_dict(np.zeros(5))
    monkeypatch.setattr(jax_loop, "eval_tracknet", lambda *a, **k: (0.0, zeros))
    monkeypatch.setattr(jax_loop, "eval_inpaintnet", lambda *a, **k: (
        0.0, {t: zeros for t in ("inpaint", "reconstruct", "baseline")}))
    for name in ("plot_heatmap_pred_sample", "plot_traj_pred_sample"):
        monkeypatch.setattr(jax_vis, name,
                            lambda *a, **k: samples.append((calls[-1], a)))
    jax_loop.train(JaxTrainConfig(model_name=model_name, epochs=1, debug=True,
                                  save_dir=save_dir, **cfg), data_dir, verbose_print=str)
    return samples


def _port_sample(monkeypatch, model_name, model, eval_step, batch, save_dir):
    seen = []
    for name in ("plot_heatmap_pred_sample", "plot_traj_pred_sample"):
        monkeypatch.setattr(vis, name, lambda *a, **k: seen.append(a))
    loop.visualize_step(model_name, eval_step,
                        {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                        save_dir, verbose_print=str)
    (args,) = seen
    return args


@pytest.mark.parametrize("bg_mode,segment_windows", [("concat", 1), ("subtract", 1),
                                                     ("concat", 2), ("subtract", 2)])
def test_tracknet_visualize_step_matches_jax(data_dir, tmp_path, monkeypatch, bg_mode,
                                             segment_windows):
    samples = _run_jax_samples(
        monkeypatch, "TrackNet", _copy(data_dir, tmp_path, "d"), str(tmp_path / "jax"),
        seq_len=SEQ, bg_mode=bg_mode, batch_size=4, input_hw=HW,
        segment_windows=segment_windows)
    assert len(samples) == 2
    key = ("seg_" if segment_windows > 1 else "") + ("rgb" if bg_mode == "concat" else "diff")
    for (state, batch), (frames, y, probs) in samples:
        assert key in batch
        model = get_model("TrackNet", SEQ, bg_mode, dtype=torch.float32)
        model.load_state_dict(tracknet_from_jax(jax.tree_util.tree_map(
            np.asarray, {"params": state.params, "batch_stats": state.batch_stats})))
        got = _port_sample(monkeypatch, "TrackNet", model,
                           steps.make_tracknet_eval_step(model, bg_mode), batch,
                           str(tmp_path / "port"))
        g_frames, g_y, g_probs = got
        assert g_frames.shape == frames.shape == (SEQ,) + HW + (3,)
        assert g_frames.dtype == frames.dtype == np.float32
        np.testing.assert_array_equal(g_frames, frames)
        np.testing.assert_array_equal(g_y, np.asarray(y))
        d = np.abs(g_probs - np.asarray(probs, np.float32))
        assert g_probs.shape == (SEQ,) + HW
        assert d.max() <= 1e-5 and d.mean() <= 1e-6, (d.max(), d.mean())


def test_inpaintnet_visualize_step_matches_jax(data_dir, tmp_path, monkeypatch):
    samples = _run_jax_samples(monkeypatch, "InpaintNet", _copy(data_dir, tmp_path, "d"),
                               str(tmp_path / "jax"), seq_len=4, batch_size=4)
    assert samples
    for (state, batch), (coor_gt, coor, mask) in samples:
        model = get_model("InpaintNet", 4, "")
        model.load_state_dict(inpaintnet_from_jax(jax.tree_util.tree_map(
            np.asarray, {"params": state.params})))
        g_gt, g_coor, g_mask = _port_sample(monkeypatch, "InpaintNet", model,
                                            steps.make_inpaintnet_eval_step(model), batch,
                                            str(tmp_path / "port"))
        np.testing.assert_array_equal(g_gt, np.asarray(coor_gt))
        np.testing.assert_array_equal(g_mask, np.asarray(mask))
        np.testing.assert_allclose(g_coor, np.asarray(coor), atol=1e-5, rtol=0)


def _small_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "rgb": torch.from_numpy(rng.integers(0, 256, (2, SEQ) + HW + (3,), dtype=np.uint8)),
        "median": torch.from_numpy(rng.integers(0, 256, (2,) + HW + (3,), dtype=np.uint8)),
        "cxcy": torch.from_numpy(rng.integers(1, 30, (2, SEQ, 2)).astype(np.int32)),
    }


def test_visualize_step_skips_and_propagates(tmp_path, monkeypatch):
    model = get_model("TrackNet", SEQ, "concat", dtype=torch.float32)
    eval_step = steps.make_tracknet_eval_step(model, "concat")
    logs = []
    monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` raises
    loop.visualize_step("TrackNet", eval_step, _small_batch(), str(tmp_path), logs.append)
    assert len(logs) == 1 and logs[0].startswith("  (viz skipped: ")
    assert not os.path.exists(tmp_path / "cur_pred.gif")

    logs.clear()
    ran = []
    loop.visualize_step("TrackNet", lambda b: ran.append(b), {"res_idx": torch.zeros(2, SEQ)},
                        str(tmp_path), logs.append)
    assert not ran and len(logs) == 1 and logs[0].startswith("  (viz skipped: ")

    def broken(batch):
        raise RuntimeError("eval step failed")

    for name in ("TrackNet", "InpaintNet"):
        with pytest.raises(RuntimeError, match="eval step failed"):
            loop.visualize_step(name, broken, _small_batch(), str(tmp_path), logs.append)


def test_sample_writer_draws_off_the_loop_and_reraises(tmp_path):
    model = get_model("TrackNet", SEQ, "concat", dtype=torch.float32)
    writer = loop.SampleWriter()
    loop.visualize_step("TrackNet", steps.make_tracknet_eval_step(model, "concat"),
                        _small_batch(1), str(tmp_path), str, writer)
    writer.wait()
    assert os.path.getsize(tmp_path / "cur_pred.gif") > 0

    def broken():
        raise ValueError("drawing failed")

    writer.submit(broken)
    with pytest.raises(ValueError, match="drawing failed"):
        writer.wait()
    writer.wait()  # raised once
    writer.submit(broken)
    with pytest.raises(ValueError, match="drawing failed"):  # at the next sample
        writer.submit(lambda: None)
