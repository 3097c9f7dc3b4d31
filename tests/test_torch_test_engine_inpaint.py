"""The port's InpaintNet evaluation and COCO export vs the JAX package's on
the CPU, on the data and checkpoints of ``tests/torch_rally_data.py`` at
float32 (as ``tests/test_torch_test_engine.py``), both engines reading the
``predicted_csv`` files the JAX engine writes:

- ``predict_rally_coordinate`` (refined coordinates within 1e-6, their
  pixels equal) and ``test()``'s dicts, in all three modes;
- COCO: the ground-truth JSON, ``get_coco_res`` and ``evaluate_ap``: equal.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import torch_rally_data as rd  # noqa: E402
from tracknetv3_tpu.evaluation import coco as jax_coco  # noqa: E402
from tracknetv3_tpu_torch.evaluation import coco  # noqa: E402

H, W = rd.H, rd.W


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The dataset with the JAX engine's ``predicted_csv`` files of the test
    split, the checkpoints, the JAX forward at float32."""
    d = tmp_path_factory.mktemp("rally")
    data = rd.write_dataset(str(d / "data"))
    tn, inp = rd.write_checkpoints(str(d))
    mp = rd.jax_f32()
    rd.engines(tn)[0].test(data, "test", save_inpaint_mask=True)
    yield data, tn, inp
    mp.undo()


@pytest.mark.parametrize("eval_mode", ["nonoverlap", "average", "weight"])
def test_inpaintnet_matches_jax(setup, eval_mode):
    jdata, tn, inp = setup
    je, te = rd.engines(tn, inp, eval_mode=eval_mode)
    rally_dir = rd.rally_dir(jdata, "1_01_00")
    want = je.predict_rally_coordinate(rally_dir)
    got = te.predict_rally_coordinate(rally_dir)
    assert got["refined"].dtype == np.float32 and got["refined"].shape == (22, 2)
    np.testing.assert_allclose(got["refined"], want["refined"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal((got["refined"] * np.float32([W, H])).astype(np.int64),
                                  (want["refined"] * np.float32([W, H])).astype(np.int64))
    for k in ("coor_gt", "coor_pred", "frame"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert te.prestage(jdata, [rally_dir], None) == 0  # InpaintNet reads no frames
    assert te.test(jdata, "test") == je.test(jdata, "test")


def _gt_json(path, root):
    """A ground-truth COCO JSON with its file names relative to ``root``."""
    with open(path) as f:
        gt = json.load(f)
    for img in gt["images"]:
        img["file_name"] = os.path.relpath(img["file_name"], root)
    return gt


def test_coco_matches_jax(setup, tmp_path):
    jdata, tn, _ = setup
    pdata = str(tmp_path / "port")  # the port writes its ground truth beside a copy
    shutil.copytree(jdata, pdata)
    pred = rd.engines(tn, eval_mode="weight")[0].test(jdata, "test", output_bbox=True)
    for drop in (True, False):
        want = _gt_json(jax_coco.convert_gt_to_coco_json(jdata, "test", drop=drop), jdata)
        got = _gt_json(coco.convert_gt_to_coco_json(pdata, "test", drop=drop), pdata)
        assert got == want and got["annotations"]
        assert coco.gt_coco_json_path(pdata, "test", drop) == os.path.join(
            pdata, f"coco_format_gt_test{'_drop' if drop else ''}.json")
        dets = coco.get_coco_res(pred, pdata, drop=drop)
        assert dets == jax_coco.get_coco_res(pred, jdata, drop=drop) and dets
        path = coco.gt_coco_json_path(pdata, "test", drop)
        for iou in (0.25, 0.5):
            assert coco.evaluate_ap(path, dets, iou) == jax_coco.evaluate_ap(path, dets, iou)
