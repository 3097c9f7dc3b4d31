"""The port's ``train()`` on the CPU: one epoch at ``input_hw=(32, 64)`` on a
small synthetic dataset, checkpoints, val metrics with the JAX loop's
keys, ``resume_training`` to epoch 2, and ``NotImplementedError`` for each
option not ported (``test_torch_train_options.py`` trains with the ported
ones)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from tracknetv3_tpu.evaluation.metrics import metrics_dict as jax_metrics_dict  # noqa: E402
from tracknetv3_tpu_torch import train as train_cli  # noqa: E402
from tracknetv3_tpu_torch.config import TrainConfig  # noqa: E402
from tracknetv3_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from tracknetv3_tpu_torch.training.loop import train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth") / "data"
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "make_synthetic_dataset.py"),
         "--out", str(out), "--width", "128", "--height", "72", "--frames", "12"],
        check=True, capture_output=True, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    return str(out)


def _cfg(save_dir, **kw):
    base = dict(seq_len=3, bg_mode="concat", batch_size=2, epochs=1, alpha=0.5,
                input_hw=(32, 64), compute_dtype="float32", save_dir=str(save_dir))
    base.update(kw)
    return TrainConfig(**base)


def test_train_one_epoch_then_resume(data_dir, tmp_path):
    torch.manual_seed(0)
    logs = []
    out = train(_cfg(tmp_path), data_dir, device="cpu", verbose_print=logs.append)
    (h,) = out["history"]
    assert h["epoch"] == 0 and np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
    assert sorted(h["val_res"]) == sorted(jax_metrics_dict(np.zeros(5)))
    steps_per_epoch = out["step"]
    assert steps_per_epoch == (2 * 2 * (12 - 3 + 1)) // 2  # 2 matches x 2 rallies, drop_last
    for name in ("TrackNet_best.pt", "TrackNet_cur.pt"):
        assert os.path.exists(tmp_path / name)
    saved = ckpt.load_checkpoint(str(tmp_path / "TrackNet_cur.pt"))
    assert saved["epoch"] == 0 and saved["scheduler"]["opt_step"] == steps_per_epoch
    assert saved["param_dict"]["input_hw"] == [32, 64]

    # resume: the checkpoint's config wins except epochs / verbose / resume
    out2 = train(_cfg(tmp_path, epochs=2, resume_training=True, batch_size=7, alpha=-1.0),
                 data_dir, device="cpu", verbose_print=logs.append)
    assert [h["epoch"] for h in out2["history"]] == [1]
    assert out2["step"] == 2 * steps_per_epoch
    assert any("Resume training from epoch 1" in str(m) for m in logs)
    assert ckpt.load_checkpoint(str(tmp_path / "TrackNet_cur.pt"))["epoch"] == 1


@pytest.mark.parametrize("field,value", [
    ("num_devices", 2), ("exact_decode", "device"), ("fast_bn", True),
    ("model_name", "InpaintNet"),
])
def test_unported_options_raise(data_dir, tmp_path, field, value):
    with pytest.raises(NotImplementedError):
        train(_cfg(tmp_path, **{field: value}), data_dir, device="cpu", verbose_print=str)


def test_cli_multihost_raises():
    with pytest.raises(NotImplementedError):
        train_cli.main(["--multihost"])
