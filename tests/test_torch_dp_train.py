"""Data-parallel ``train()`` on a two-entry CPU mesh against ``train()`` on
one device (here with sample mixup; ``test_torch_dp_train_resident.py``
with resident frames; ``test_torch_dp_processes.py`` over two processes),
and the resident loader on a mesh and over processes, on a small
synthetic dataset (``tools/make_synthetic_dataset.py``, 6 frames a rally)
at ``input_hw=(32, 64)``, seq_len 3, batch 4.

The two runs train in float64 (the factory is patched to build float64
TrackNets): in float32 a train-mode BatchNorm at batch 4 amplifies the
rounding of a reordered sum, and two runs that compute the same function
part by 0.4% in the loss and 12% in the parameters within 15 steps (the
step API, both ways), while in float64 they agree to 2e-11. So: two epochs;
each epoch's train and val loss within 1e-10 relative, the val metrics
equal, the same best epoch, the final parameters within 1e-10 relative L2.
"""

import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from tracknetv3_tpu_torch.config import TrainConfig  # noqa: E402
from tracknetv3_tpu_torch.data import dataset as ds  # noqa: E402
from tracknetv3_tpu_torch.parallel.mesh import make_mesh, shard_train_batch  # noqa: E402
from tracknetv3_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from tracknetv3_tpu_torch.training import loop  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = 1e-10


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth") / "data"
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "make_synthetic_dataset.py"),
         "--out", str(out), "--width", "128", "--height", "72", "--frames", "6"],
        check=True, capture_output=True, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    return str(out)


def float64_models():
    real = loop.get_model

    def build(*args, **kw):
        kw["dtype"] = torch.float64
        return real(*args, **kw).double()

    return mock.patch.object(loop, "get_model", build)


def _cfg(save_dir, **kw):
    base = dict(seq_len=3, bg_mode="concat", batch_size=4, epochs=2, alpha=0.5,
                input_hw=(32, 64), compute_dtype="float32", save_dir=str(save_dir))
    base.update(kw)
    return TrainConfig(**base)


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def assert_same_training(got, want, got_dir, want_dir):
    assert len(got["history"]) == len(want["history"]) == 2
    assert got["step"] == want["step"]
    for g, w in zip(got["history"], want["history"]):
        assert _rel(g["train_loss"], w["train_loss"]) <= BOUND
        assert _rel(g["val_loss"], w["val_loss"]) <= BOUND
        assert g["val_res"] == w["val_res"]
    best = [ckpt.load_checkpoint(os.path.join(d, "TrackNet_best.pt"))
            for d in (got_dir, want_dir)]
    assert best[0]["epoch"] == best[1]["epoch"] and best[0]["max_val_acc"] == best[1]["max_val_acc"]
    sg, sw = got["model"].state_dict(), want["model"].state_dict()
    for k in sw:
        assert float((sg[k] - sw[k]).norm() / max(float(sw[k].norm()), 1e-30)) <= BOUND, k


def mesh_against_one_device(data_dir, tmp_path, **options):
    logs = []
    try:
        with float64_models():
            want = loop.train(_cfg(tmp_path / "one", **options), data_dir, device="cpu",
                              verbose_print=str)
            got = loop.train(_cfg(tmp_path / "mesh", num_devices=2, **options), data_dir,
                             device="cpu", verbose_print=logs.append)
        assert_same_training(got, want, tmp_path / "mesh", tmp_path / "one")
    finally:  # 130 MB a full-width checkpoint: keep the suite's temp folders small
        for d in ("one", "mesh"):
            shutil.rmtree(tmp_path / d, ignore_errors=True)
    return logs


def test_mesh_training_with_sample_mixup_follows_one_device(data_dir, tmp_path):
    logs = mesh_against_one_device(data_dir, tmp_path)
    assert not any("Resident frames" in str(m) for m in logs)


def test_resident_loader_on_a_mesh_and_over_processes(data_dir):
    idx = ds.build_split_index(data_dir, "train", 3, 1, input_hw=(32, 64))
    kw = dict(batch_size=4, shuffle=True, drop_last=True, seed=3, data_dir=data_dir)
    one = list(ds.ResidentHeatmapLoader(idx, "concat", device="cpu", **kw))
    mesh = make_mesh(2, device="cpu")
    on_mesh = ds.ResidentHeatmapLoader(idx, "concat", mesh=mesh, device="cpu", **kw)
    assert on_mesh.frame_sharding == "replicate"
    for b_one, b_mesh in zip(one, on_mesh):
        # every entry holds the split's buffers (one tensor: both entries are the CPU)
        assert len(b_mesh["res_rgb_buf"]) == 2
        assert b_mesh["res_rgb_buf"][0] is b_mesh["res_rgb_buf"][1]
        assert torch.equal(b_mesh["res_rgb_buf"][0], b_one["res_rgb_buf"])
        shares = shard_train_batch({k: torch.as_tensor(v) if k.startswith("res_") and
                                    not k.endswith("_buf") else v for k, v in b_mesh.items()},
                                   mesh)
        for i, share in enumerate(shares):
            assert share["res_rgb_buf"] is b_mesh["res_rgb_buf"][i]
            assert np.array_equal(share["res_idx"].numpy(), b_one["res_idx"][2 * i:2 * i + 2])
    # over processes: each holds the buffers whole and takes its rows
    procs = [list(ds.ResidentHeatmapLoader(idx, "concat", device="cpu", process_id=p,
                                           process_count=2, **kw)) for p in (0, 1)]
    for b_one, b0, b1 in zip(one, *procs):
        for k in ("res_idx", "res_median_idx", "cxcy", "id"):
            np.testing.assert_array_equal(np.concatenate([b0[k], b1[k]]), b_one[k])
        assert torch.equal(b0["res_rgb_buf"], b_one["res_rgb_buf"])
