"""The port's ``RallyTestEngine`` heatmap path vs the JAX package's on the
CPU in the temporal-ensemble modes ``average`` and ``weight`` (the carried
tail and its flush), on the data and checkpoint of
``tests/torch_rally_data.py`` at float32 (as
``tests/test_torch_test_engine.py``): ``predict_rally_heatmap`` with
``exact_decode`` False / True / ``"host"``, ``cx``, ``cy``, ``bbox``
bit-equal, ``conf`` within 1e-5.
"""

import pytest
import shutil

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import torch_rally_data as rd  # noqa: E402


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("rally")
    data = rd.write_dataset(str(d / "data"))
    tn, _ = rd.write_checkpoints(str(d))
    mp = rd.jax_f32()
    yield data, tn
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each
    mp.undo()


@pytest.mark.parametrize("exact_decode", [False, True, "host"])
@pytest.mark.parametrize("eval_mode", ["average", "weight"])
def test_predict_rally_heatmap_matches_jax(setup, eval_mode, exact_decode):
    rd.check_heatmap_rows(*setup, eval_mode, exact_decode)
