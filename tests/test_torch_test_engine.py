"""The port's ``RallyTestEngine`` heatmap path vs the JAX package's on the
CPU, ``nonoverlap`` mode (``tests/test_torch_test_engine_ensemble.py`` holds
the ensemble modes).

Both engines load the same checkpoint, written by the JAX package's
``save_checkpoint`` from a JAX random init, and run at float32
(``tests/torch_rally_data.py``): 32x64 model resolution from 64x128 PNGs,
seq_len 3, batch 4, two test rallies of 22 and 9 frames.
``predict_rally_heatmap`` with ``exact_decode`` False / True / ``"host"``:
``cx``, ``cy``, ``bbox`` bit-equal, ``conf`` within 1e-5; the heatmaps hold
multi-blob frames on which the exact rule and the peak blob disagree.
"""

import pytest

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
    mp.undo()


@pytest.mark.parametrize("exact_decode", [False, True, "host"])
@pytest.mark.parametrize("eval_mode", ["nonoverlap"])
def test_predict_rally_heatmap_matches_jax(setup, eval_mode, exact_decode):
    rd.check_heatmap_rows(*setup, eval_mode, exact_decode)


@pytest.mark.parametrize("eval_mode", ["nonoverlap", "weight"])
def test_exact_rule_meets_multiblob_frames(setup, eval_mode):
    """The heatmaps compared hold frames where the largest-bbox blob is not
    the brightest one, so the exact decode cases test the rule."""
    data, tn = setup
    rally, T = rd.RALLIES["test"][0]
    peak = rd.predict(rd.engines(tn, eval_mode=eval_mode)[1], data, rally, T)
    exact = rd.predict(rd.engines(tn, eval_mode=eval_mode, exact_decode=True)[1], data,
                       rally, T)
    assert (peak["cx"] != exact["cx"]).any()
