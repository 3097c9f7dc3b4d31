"""The port's CLIs with the flags of this slice against the JAX CLIs, run
in this process on the CPU (float32; the predict CLI's model resolution cut
to 32x64; ``tests/torch_serving_data.py``, ``tests/torch_rally_data.py``):

- ``predict``: default flags (the native reader, YUV420 staging),
  ``--cv2_decode``, ``--stage_format yuv420`` and ``bgr`` each write the
  JAX CLI's CSV with the same flags, byte for byte; ``--profile DIR``
  writes a chrome trace there; an unknown ``--stage_format`` is a parser
  error;
- ``test --video_file {...}/video/{rally}.mp4``: the JAX CLI's
  ``{rally}_ball.csv`` (``Frame, Visibility, X, Y``), and an overlay
  ``{rally}.mp4`` whose frames are the JAX CLI's.
"""

import json
import os
import runpy
import shutil
import sys

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import torch_rally_data as rd  # noqa: E402
import tracknetv3_tpu.inference as jinf  # noqa: E402
from tests.torch_serving_data import (  # noqa: E402
    B, H, JAX_F32, W, csv_text, detecting_checkpoint, read_rgb, write_clip,
)
from tracknetv3_tpu_torch import inference as tinf  # noqa: E402
from tracknetv3_tpu_torch import predict as predict_cli  # noqa: E402
from tracknetv3_tpu_torch import test as test_cli  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_cli(script: str, argv, monkeypatch) -> None:
    """The JAX package's root CLI ``script`` as ``python script argv``, in
    this process, without its persistent compile cache."""
    monkeypatch.setenv("TRACKNETV3_TPU_CACHE_DIR", "0")
    monkeypatch.setattr(sys, "argv", [script] + list(argv))
    runpy.run_path(os.path.join(ROOT, script), run_name="__main__")


@pytest.fixture(scope="module")
def clip_and_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_cli")
    clip = write_clip(str(d / "rally.mp4"), 15, seed=19)
    yield clip, detecting_checkpoint(str(d / "tn.pt"), "concat", clip)
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each


@pytest.fixture
def small_clis(monkeypatch):
    """Both predict CLIs at the test's model resolution, float32."""
    monkeypatch.setattr(tinf, "HEIGHT", H)
    monkeypatch.setattr(tinf, "WIDTH", W)
    monkeypatch.setattr(jinf, "HEIGHT", H)
    monkeypatch.setattr(jinf, "WIDTH", W)
    made = []
    real = tinf.TrackNetPredictor

    def port_f32(*a, compute_dtype=None, **kw):
        made.append(real(*a, compute_dtype=torch.float32, **kw))
        return made[-1]

    monkeypatch.setattr(tinf, "TrackNetPredictor", port_f32)
    monkeypatch.setattr(jinf, "TrackNetPredictor", JAX_F32)
    return made


@pytest.mark.parametrize("flags,backend", [
    ([], "native-lowres1+yuv420"),
    (["--cv2_decode"], "cv2"),
    (["--stage_format", "yuv420"], "native-lowres1+yuv420"),
    (["--stage_format", "bgr"], "native-lowres1"),
])
def test_predict_cli_decode_flags_write_the_jax_cli_csv(clip_and_ckpt, small_clis, tmp_path,
                                                        monkeypatch, flags, backend):
    clip, tn = clip_and_ckpt
    common = ["--video_file", clip, "--tracknet_file", tn, "--batch_size", str(B)]
    run_jax_cli("predict.py", common + ["--save_dir", str(tmp_path / "jax")] + flags,
                monkeypatch)
    predict_cli.main(common + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"] + flags)
    assert small_clis[0].decode_backend == backend
    got = csv_text(tmp_path / "port" / "rally_ball.csv")
    assert got == csv_text(tmp_path / "jax" / "rally_ball.csv")
    assert len(got.splitlines()) == 16


def test_predict_cli_profile_writes_a_chrome_trace(clip_and_ckpt, small_clis, tmp_path):
    clip, tn = clip_and_ckpt
    pred = predict_cli.main(["--video_file", clip, "--tracknet_file", tn, "--device", "cpu",
                             "--batch_size", str(B), "--save_dir", str(tmp_path / "out"),
                             "--profile", str(tmp_path / "prof")])
    assert len(pred["Frame"]) == 15
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "serve::forward" in names and "serve::yuv420_to_rgb" in names
    with open(tmp_path / "prof" / "spans.json") as f:
        spans = json.load(f)
    assert {"serve::forward", "serve::decode", "serve::csv"} <= set(spans["spans"])
    assert sum(spans["idle_by_span"].values()) == pytest.approx(spans["idle_s"])
    assert os.path.exists(tmp_path / "out" / "rally_ball.csv")


@pytest.mark.parametrize("flags", [["--stage_format", "nv12"], ["--cv2_decode", "yes"]])
def test_predict_cli_refuses_bad_decode_flags(flags):
    with pytest.raises(SystemExit) as e:
        predict_cli.main(["--video_file", "v.mp4", "--tracknet_file", "t.pt", "--device",
                          "cpu"] + flags)
    assert e.value.code == 2


@pytest.fixture(scope="module")
def rally(tmp_path_factory):
    """The rally dataset with ``test/match1/video/1_01_00.mp4`` made from
    the rally's frames."""
    d = tmp_path_factory.mktemp("rally_video")
    data = rd.write_dataset(str(d / "data"))
    tn, _ = rd.write_checkpoints(str(d))
    rally_id, T = rd.RALLIES["test"][0]
    frames = os.path.join(data, "test", "match1", "frame", rally_id)
    os.makedirs(os.path.join(data, "test", "match1", "video"))
    video = os.path.join(data, "test", "match1", "video", f"{rally_id}.mp4")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30, (2 * W, 2 * H))
    for t in range(T):
        vw.write(cv2.imread(os.path.join(frames, f"{t}.png")))
    vw.release()
    yield data, tn, video, rally_id, T
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each


def test_test_cli_video_file_writes_the_jax_cli_files(rally, tmp_path, monkeypatch):
    data, tn, video, rally_id, T = rally
    asked = rd.port_engine_f32(monkeypatch)
    monkeypatch.setattr(rd.jax_ff, "tracknet_fused_forward", rd.functools.partial(
        rd.jax_ff.tracknet_fused_forward, dtype=rd.jnp.float32))
    argv = ["--tracknet_file", tn, "--data_dir", data, "--batch_size", str(B),
            "--video_file", video]
    run_jax_cli("test.py", argv + ["--save_dir", str(tmp_path / "jax")], monkeypatch)
    out = test_cli.main(argv + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert asked == [None]  # the CLI serves at the engine's default dtype
    assert sorted(os.listdir(tmp_path / "port")) == [f"{rally_id}.mp4", f"{rally_id}_ball.csv"]
    got = csv_text(tmp_path / "port" / f"{rally_id}_ball.csv")
    assert got == csv_text(tmp_path / "jax" / f"{rally_id}_ball.csv")
    assert got.splitlines()[0] == "Frame,Visibility,X,Y" and len(got.splitlines()) == T + 1
    assert sum(out["pred"]["Visibility"]) > 0
    port_frames = read_rgb(str(tmp_path / "port" / f"{rally_id}.mp4"))
    assert port_frames.shape == (T, 2 * H, 2 * W, 3)
    np.testing.assert_array_equal(port_frames,
                                  read_rgb(str(tmp_path / "jax" / f"{rally_id}.mp4")))
    assert not np.array_equal(port_frames, read_rgb(video))  # the trajectories were drawn


def test_test_cli_video_file_refuses_other_paths(rally, tmp_path):
    data, tn, _, _, _ = rally
    with pytest.raises(ValueError, match="Not a dataset video path"):
        test_cli.main(["--tracknet_file", tn, "--data_dir", data, "--device", "cpu",
                       "--video_file", str(tmp_path / "clip.avi"),
                       "--save_dir", str(tmp_path)])
