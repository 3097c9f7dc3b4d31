"""The port's evaluation CLI on the CPU: ``python -m
tracknetv3_tpu_torch.test --device cpu``.

Its ``main()`` writes the JSON files that the JAX package's engine gives on
the same data and checkpoints (``tests/torch_rally_data.py``), in ``weight``
and ``nonoverlap``, with the exact decode on the device and on the host, with
``--linear_interp``, with InpaintNet, ``--output_bbox`` and ``--output_pred``:
the engine of each package made at float32 (the CLI serves TrackNet at the
engine's default, bfloat16, which the test records and replaces).
``generate_mask_data`` and the refused flags: ``tests/test_torch_mask_cli.py``.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import torch_rally_data as rd  # noqa: E402
import tracknetv3_tpu.evaluation.test_engine as jax_te  # noqa: E402
from tracknetv3_tpu.evaluation import coco as jax_coco  # noqa: E402
from tracknetv3_tpu_torch import test as test_cli  # noqa: E402

L, B = rd.L, rd.B


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The dataset with the JAX engine's ``predicted_csv`` files of the test
    split (for the InpaintNet run), the checkpoints, the JAX forward at
    float32."""
    d = tmp_path_factory.mktemp("cli")
    data = rd.write_dataset(str(d / "data"))
    tn, inp = rd.write_checkpoints(str(d))
    mp = rd.jax_f32()
    rd.engines(tn)[0].test(data, "test", save_inpaint_mask=True)
    yield data, tn, inp
    mp.undo()


@pytest.fixture()
def port_f32(monkeypatch):
    """The port's engine at float32; records the dtype each CLI asked for."""
    return rd.port_engine_f32(monkeypatch)


RUNS = {
    "weight": [],
    "nonoverlap_exact": ["--eval_mode", "nonoverlap", "--exact_decode"],
    "host_bbox_pred": ["--exact_decode", "host", "--output_bbox", "--output_pred"],
    "linear_interp": ["--linear_interp", "--output_pred"],
    "inpaintnet": ["--eval_mode", "average", "--inpaintnet", "--output_pred"],
}


@pytest.mark.parametrize("run", list(RUNS))
def test_test_cli_writes_what_the_jax_engine_gives(setup, port_f32, tmp_path, run):
    data, tn, inp = setup
    flags = list(RUNS[run])
    with_inpaint = "--inpaintnet" in flags
    if with_inpaint:
        flags[flags.index("--inpaintnet")] = "--inpaintnet_file"
        flags.insert(flags.index("--inpaintnet_file") + 1, inp)
    mode = flags[flags.index("--eval_mode") + 1] if "--eval_mode" in flags else "weight"
    exact = ""
    if "--exact_decode" in flags:
        i = flags.index("--exact_decode")
        exact = flags[i + 1] if i + 1 < len(flags) and flags[i + 1] == "host" else "device"
    out = test_cli.main(["--tracknet_file", tn, "--data_dir", data, "--batch_size", str(B),
                         "--save_dir", str(tmp_path), "--device", "cpu"] + flags)
    assert port_f32 == [None]  # the CLI serves at the engine's default dtype

    engine = rd.engines(tn, inp if with_inpaint else None, eval_mode=mode,
                        exact_decode=exact)[0]
    want = engine.test(data, "test", use_linear_interp="--linear_interp" in flags,
                       output_bbox="--output_bbox" in flags)
    want_res = jax_te.get_test_res(want, data, drop=True)
    with open(tmp_path / f"test_eval_res_{mode}.json") as f:
        got_res = json.load(f)
    assert set(got_res.pop("eval_speed")) == {"frames", "seconds", "fps"}
    assert got_res == want_res

    def rows(pred):
        return {k: {c: v for c, v in p.items() if c != "Confidence"} for k, p in pred.items()}

    if "--output_pred" in flags:
        with open(tmp_path / f"test_eval_analysis_{mode}.json") as f:
            analysis = json.load(f)
        assert rows(analysis["pred_dict"]) == rows(want)
        assert analysis["param_dict"]["tracknet_seq_len"] == L
        assert analysis["param_dict"]["device"] == "cpu"
    else:
        assert not os.path.exists(tmp_path / f"test_eval_analysis_{mode}.json")
    if "--output_bbox" in flags:
        with open(tmp_path / f"test_coco_res_{mode}.json") as f:
            got_coco = json.load(f)
        dets = jax_coco.get_coco_res(want, data, drop=True)
        gt = jax_coco.gt_coco_json_path(data, "test", drop=True)
        want_ap = {str(iou): jax_coco.evaluate_ap(gt, dets, iou) for iou in (0.25, 0.5)}
        assert got_coco["AP_25"] == want_ap
        for g, w in zip(got_coco["detection"], dets):
            assert g["score"] == pytest.approx(w["score"], abs=1e-5)
            g.pop("score"), w.pop("score")
        assert got_coco["detection"] == dets
        assert rows(out["pred_dict"]) == rows(want)
