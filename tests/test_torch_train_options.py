"""The port's ``train()`` on the CPU with each option of the segmented /
frame-mixup / device-resident input paths: one epoch at ``input_hw=(32, 64)``
on a small synthetic dataset, the step count of the option's loader, finite
losses, val metrics, and a checkpoint that the JAX package loads with the
option in its ``param_dict``; a split over the resident budget falls back to
the host loader."""

import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from tracknetv3_tpu.evaluation.metrics import metrics_dict as jax_metrics_dict  # noqa: E402
from tracknetv3_tpu.training import checkpoint as jax_ckpt  # noqa: E402
from tracknetv3_tpu_torch.config import TrainConfig  # noqa: E402
from tracknetv3_tpu_torch.training import loop  # noqa: E402
from tracknetv3_tpu_torch.training.loop import train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth") / "data"
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "make_synthetic_dataset.py"),
         "--out", str(out), "--width", "128", "--height", "72", "--frames", "8"],
        check=True, capture_output=True, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    return str(out)


def _cfg(save_dir, **kw):
    base = dict(seq_len=3, bg_mode="concat", batch_size=2, epochs=1, alpha=0.5,
                input_hw=(32, 64), compute_dtype="float32", save_dir=str(save_dir))
    base.update(kw)
    return TrainConfig(**base)


# windows of the train split: 2 matches x 2 rallies x (8 - 3 + 1)
N_TRAIN = 24


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each test's checkpoints and save_dir (a full-width TrackNet checkpoint
    is 130 MB whatever input_hw) go once the test has read them."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("options,steps,resident", [
    # 3 non-overlapping 2-window segments a rally, one segment a batch
    (dict(segment_windows=2), 12, False),
    (dict(frame_alpha=0.5), N_TRAIN // 2, False),
    (dict(frame_alpha=0.5, alpha=-1.0), N_TRAIN // 2, False),  # the two-disk loss
    (dict(resident_frames=True), N_TRAIN // 2, True),
    (dict(resident_frames=True, bg_mode="subtract_concat"), N_TRAIN // 2, True),
    # frame mixup needs the host planner: the host loader serves the run
    (dict(resident_frames=True, frame_alpha=0.5), N_TRAIN // 2, False),
])
def test_ported_options_train_an_epoch(data_dir, tmp_path, options, steps, resident):
    torch.manual_seed(0)
    logs = []
    out = train(_cfg(tmp_path, **options), data_dir, device="cpu", verbose_print=logs.append)
    (h,) = out["history"]
    assert np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
    assert sorted(h["val_res"]) == sorted(jax_metrics_dict(np.zeros(5)))
    assert out["step"] == steps
    assert any("Resident frames" in str(m) for m in logs) == resident
    # the JAX package loads the checkpoint, options included
    _, variables, pd = jax_ckpt.load_model_from_checkpoint(str(tmp_path / "TrackNet_cur.pt"))
    assert {"params", "batch_stats"} <= set(variables)
    for k, v in options.items():
        assert pd[k] == v, k


def test_resident_frames_over_budget_fall_back_to_the_host_loader(data_dir, tmp_path):
    def over_budget(*args, **kw):
        raise MemoryError("split frames (9.0 GB) exceed the resident budget (6.0 GB)")

    logs = []
    with mock.patch.object(loop, "ResidentHeatmapLoader", over_budget):
        out = train(_cfg(tmp_path, resident_frames=True), data_dir, device="cpu",
                    verbose_print=logs.append)
    assert out["step"] == N_TRAIN // 2 and np.isfinite(out["history"][0]["train_loss"])
    assert any(str(m).startswith("resident_frames fallback: split frames") for m in logs)
