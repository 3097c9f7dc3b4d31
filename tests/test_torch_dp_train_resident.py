"""``train(num_devices=2, resident_frames=True)`` on a CPU mesh (each entry
holding the split's frames, ``frame_sharding="replicate"``) against one
device, two epochs in float64 at the bounds and on the data of
``test_torch_dp_train.py``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from test_torch_dp_train import data_dir, mesh_against_one_device  # noqa: E402,F401


def test_mesh_training_on_resident_frames_follows_one_device(data_dir, tmp_path):  # noqa: F811
    logs = mesh_against_one_device(data_dir, tmp_path, resident_frames=True, alpha=-1.0)
    assert any("Resident frames" in str(m) for m in logs)
