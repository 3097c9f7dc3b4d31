"""The port's rally evaluation above the heatmap path vs the JAX package's on
the CPU, on the data and checkpoints of ``tests/torch_rally_data.py`` at
float32 (as ``tests/test_torch_test_engine.py``):

- ``test(save_inpaint_mask=True)`` (what ``generate_mask_data`` runs): the
  prediction dicts equal and the ``predicted_csv`` files byte-equal;
- ``test()`` with ``output_bbox`` / ``output_gt``, its ``last_eval_stats``,
  and ``get_test_res`` with and without the drop-frame window: equal;
- ``test_rally_linear`` (``use_linear_interp``): equal.

InpaintNet and COCO: ``tests/test_torch_test_engine_inpaint.py``.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import torch_rally_data as rd  # noqa: E402
from tracknetv3_tpu.evaluation.test_engine import get_test_res as jax_get_test_res  # noqa: E402
from tracknetv3_tpu_torch.evaluation.test_engine import get_test_res  # noqa: E402



@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A dataset for each package (each writes its own ``predicted_csv``
    files), the checkpoints, and the JAX forward at float32."""
    d = tmp_path_factory.mktemp("rally")
    rd.write_dataset(str(d / "jax"))
    shutil.copytree(d / "jax", d / "port")
    tn, inp = rd.write_checkpoints(str(d))
    mp = rd.jax_f32()
    yield str(d / "jax"), str(d / "port"), tn, inp
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each
    mp.undo()


def _csvs(data):
    out = {}
    for split in ("test", "train"):
        d = os.path.join(data, split, "match1", "predicted_csv")
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as f:
                out[split, name] = f.read()
    return out


@pytest.fixture(scope="module")
def mask_data(setup):
    """Both packages' mask-data generation (weight mode, the JAX CLI's
    default) over the test and train splits."""
    jdata, pdata, tn, _ = setup
    je, te = rd.engines(tn, eval_mode="weight")
    dicts = {}
    for split in ("test", "train"):
        dicts[split] = (je.test(jdata, split, save_inpaint_mask=True),
                        te.test(pdata, split, save_inpaint_mask=True))
    return dicts


def test_mask_data_dicts_and_csvs_match_jax(setup, mask_data):
    jdata, pdata, _, _ = setup
    for split, (want, got) in mask_data.items():
        assert got == want, split
    want, got = _csvs(jdata), _csvs(pdata)
    assert len(got) == 3 and got == want
    header = got["test", "1_01_00_ball.csv"].decode().splitlines()[0]
    assert header == "Frame,Visibility_GT,X_GT,Y_GT,Visibility,X,Y,Inpaint_Mask"
    assert sum(mask_data["test"][1]["1_1_01_00"]["Visibility"]) > 0


@pytest.mark.parametrize("eval_mode,exact_decode", [("nonoverlap", True), ("weight", "host"),
                                                    ("average", False)])
def test_test_dicts_and_metrics_match_jax(setup, eval_mode, exact_decode):
    jdata, pdata, tn, _ = setup
    je, te = rd.engines(tn, eval_mode=eval_mode, exact_decode=exact_decode)
    want = je.test(jdata, "test", output_bbox=True, output_gt=True)
    got = te.test(pdata, "test", output_bbox=True, output_gt=True)
    assert list(got) == ["1_1_01_00", "1_1_02_00"]
    for key in want:
        conf_w, conf_g = want[key].pop("Confidence"), got[key].pop("Confidence")
        np.testing.assert_allclose(conf_g, conf_w, rtol=0, atol=1e-5)
        assert got[key] == want[key], key
    for drop in (True, False):
        assert get_test_res(got, pdata, drop=drop) == jax_get_test_res(want, jdata, drop=drop)
    assert te.last_eval_stats["frames"] == 31 and set(te.last_eval_stats) == {
        "frames", "seconds", "fps"}
    res = get_test_res(got, pdata, drop=True)
    assert sum(res[t] for t in ("TP", "TN", "FP1", "FP2", "FN")) == (19 - 2) + (9 - 1)


def test_linear_interp_matches_jax(setup):
    jdata, pdata, tn, _ = setup
    je, te = rd.engines(tn, eval_mode="weight")
    want = je.test(jdata, "test", use_linear_interp=True)
    got = te.test(pdata, "test", use_linear_interp=True)
    assert got == want
