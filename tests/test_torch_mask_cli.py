"""The port's mask-data CLI on the CPU: ``python -m
tracknetv3_tpu_torch.generate_mask_data --device cpu`` writes the
``predicted_csv`` files of the JAX package's engine, byte for byte, on the
data and checkpoints of ``tests/torch_rally_data.py`` (both engines at
float32). ``--num_devices 2`` shards both evaluation CLIs over a 2-entry
CPU mesh, with the files of the single device (the test CLI's ``--video_file``
runs since it was ported); ``--exact_decode`` takes the JAX CLIs' values.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import torch_rally_data as rd  # noqa: E402
import tracknetv3_tpu.evaluation.test_engine as jax_te  # noqa: E402
from tracknetv3_tpu_torch import generate_mask_data as mask_cli  # noqa: E402
from tracknetv3_tpu_torch import test as test_cli  # noqa: E402
from tracknetv3_tpu_torch.evaluation import test_engine as port_te  # noqa: E402

H, W, B = rd.H, rd.W, rd.B


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("mask_cli")
    data = rd.write_dataset(str(d / "data"))
    tn, _ = rd.write_checkpoints(str(d))
    mp = rd.jax_f32()
    yield data, tn
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each
    mp.undo()


def test_generate_mask_data_cli_writes_the_jax_csvs(setup, tmp_path, monkeypatch):
    """Both packages' mask-data runs at the model resolution of the test
    (the CLIs run the config's resolution: patched in both engines)."""
    data, tn = setup
    port_f32 = rd.port_engine_f32(monkeypatch)
    for mod in (jax_te, port_te):
        monkeypatch.setattr(mod, "HEIGHT", H)
        monkeypatch.setattr(mod, "WIDTH", W)
    jdata, pdata = str(tmp_path / "jax"), str(tmp_path / "port")
    for d in (jdata, pdata):
        shutil.copytree(data, d, ignore=shutil.ignore_patterns("predicted_csv"))
    stats = mask_cli.main(["--tracknet_file", tn, "--data_dir", pdata, "--batch_size", str(B),
                           "--split_list", "train,test", "--exact_decode", "--device", "cpu"])
    assert port_f32 == [None] and set(stats) == {"train", "test"}
    engine = rd.engines(tn, exact_decode="device")[0]
    for split in ("train", "test"):
        engine.test(jdata, split, save_inpaint_mask=True)
    n = 0
    for split, rallies in rd.RALLIES.items():
        for rally, T in rallies:
            rel = os.path.join(split, "match1", "predicted_csv", f"{rally}_ball.csv")
            with open(os.path.join(pdata, rel), "rb") as g, open(os.path.join(jdata, rel),
                                                                   "rb") as w:
                got = g.read()
                assert got == w.read(), rel
            assert len(got.decode().splitlines()) == T + 1
            n += 1
    assert n == 3


@pytest.mark.parametrize("cli,flags", [
    ("test", ["--video_file", "rally.mp4"]),
    ("test", ["--num_devices", "2"]),
    ("generate_mask_data", ["--num_devices", "2"]),
])
def test_unported_flags_raise(setup, cli, flags, tmp_path, monkeypatch):
    """``--num_devices 2 --device cpu`` runs each CLI's engine on a 2-entry
    CPU mesh and writes the files of the single-device run: the test CLI's
    prediction dicts, metrics and analysis file, the mask-data CLI's
    ``predicted_csv`` files byte for byte. The test CLI's ``--video_file``,
    ported since, takes the path and refuses one outside a dataset's
    ``video/`` directory (its run on a rally video is
    ``tests/test_torch_native_cli.py``'s)."""
    data, tn = setup
    main = test_cli.main if cli == "test" else mask_cli.main
    if flags[0] == "--video_file":
        with pytest.raises(ValueError, match="Not a dataset video path"):
            main(["--tracknet_file", tn, "--device", "cpu"] + flags)
        return
    monkeypatch.setattr(port_te, "HEIGHT", H)
    monkeypatch.setattr(port_te, "WIDTH", W)
    meshes = []
    real_engine = port_te.RallyTestEngine

    def engine_f32(*args, compute_dtype=None, mesh=None, **kwargs):
        meshes.append(None if mesh is None else [str(d) for d in mesh.devices])
        return real_engine(*args, compute_dtype=torch.float32, mesh=mesh, **kwargs)

    monkeypatch.setattr(port_te, "RallyTestEngine", engine_f32)
    files = {}
    for tag, extra in (("one", []), ("mesh", flags)):
        d = str(tmp_path / tag)
        shutil.copytree(data, d, ignore=shutil.ignore_patterns("predicted_csv"))
        argv = ["--tracknet_file", tn, "--data_dir", d, "--batch_size", str(B), "--device",
                "cpu"] + extra
        if cli == "test":
            out = main(argv + ["--save_dir", os.path.join(d, "out"), "--output_pred"])
            names = ["test_eval_res_weight.json", "test_eval_analysis_weight.json"]
            files[tag] = {"pred": out["pred_dict"], "res": {k: v for k, v in out["res"].items()
                                                            if k != "eval_speed"}}
            with open(os.path.join(d, "out", names[1])) as f:
                files[tag]["analysis"] = json.load(f)["pred_dict"]
            assert os.path.exists(os.path.join(d, "out", names[0]))
        else:
            main(argv + ["--split_list", "test"])
            files[tag] = {}
            for r, _ in rd.RALLIES["test"]:
                with open(os.path.join(d, "test", "match1", "predicted_csv", f"{r}_ball.csv"),
                          "rb") as f:
                    files[tag][r] = f.read()
    assert meshes == [None, ["cpu", "cpu"]]
    assert files["mesh"] == files["one"]


def test_exact_decode_flag_values():
    for p in (test_cli.build_parser(), mask_cli.build_parser()):
        assert p.parse_args(["--tracknet_file", "t"]).exact_decode == ""
        assert p.parse_args(["--tracknet_file", "t", "--exact_decode"]).exact_decode == "device"
        assert p.parse_args(["--tracknet_file", "t", "--exact_decode", "host"]
                            ).exact_decode == "host"
        assert p.parse_args(["--tracknet_file", "t"]).device == "cuda"
    assert np.array_equal(mask_cli.build_parser().parse_args(
        ["--tracknet_file", "t"]).split_list, ["train", "val", "test"])
