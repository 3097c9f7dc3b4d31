"""TrackNetV1 on the port's serving path, on the CPU:

- the window order: ``make_staged_preprocessor(v1_order=True)`` stacks
  frames t, t-1, t-2 in BGR / 255, from RGB or BGR staging;
- ``TrackNetPredictor.run_staged`` on a TrackNetV1 checkpoint (seeded
  weights with the benchmark's detector path, YUV420 frames of its scene,
  48x80, batch 4) writes the rows of the plain reference
  (``port_bench/reference/tracknet_v1.clip_rows``), frames 0 and 1
  invisible, through the ``serve::classify`` span;
- the npz checkpoint round trip, and the converter of a ``BallTrackerNet``
  state dict written by the reference's copy of the published module;
- ``predict.py`` serves a TrackNetV1 checkpoint with no new flag: its
  resolution from the checkpoint, ``--eval_mode`` not read; streaming,
  device resize and InpaintNet raise.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import cv2  # noqa: E402

from tracknetv3_tpu_torch import convert_reference_checkpoint as conv  # noqa: E402
from tracknetv3_tpu_torch import inference as tinf  # noqa: E402
from tracknetv3_tpu_torch import predict as predict_cli  # noqa: E402
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402
from tracknetv3_tpu_torch.ops.preprocess import make_staged_preprocessor  # noqa: E402
from tracknetv3_tpu_torch.training.checkpoint import (load_model_from_checkpoint,  # noqa: E402
                                                      save_checkpoint)
from tracknetv3_tpu_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "port_bench"))
from benchkit import scene, weights_v1  # noqa: E402
from reference import tracknet_v1 as ref  # noqa: E402

H, W, B = 48, 80, 4
DETECTOR = {"gain": 16.0, "threshold": 0.375, "mix": 3.0, "level": 2.0}


@pytest.fixture
def v1_ckpt(tmp_path):
    """A TrackNetV1 checkpoint of a seeded module at 32x64 (its param_dict's
    resolution)."""
    model = get_model("TrackNetV1", generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "TrackNetV1_best.pt")
    save_checkpoint(path, epoch=0, max_val_acc=0.0, model=model,
                    param_dict={"model_name": "TrackNetV1", "seq_len": 3, "bg_mode": "",
                                "height": 32, "width": 64})
    yield path, model
    os.remove(path)


@pytest.mark.parametrize("bgr", [False, True])
def test_windows_are_newest_first_in_bgr(bgr):
    rgb = np.random.default_rng(1).integers(0, 255, (7, 8, 16, 3), np.uint8)
    buf = torch.from_numpy(rgb[..., ::-1].copy() if bgr else rgb)
    pre = make_staged_preprocessor("", 3, bgr, v1_order=True)
    x = pre(buf, None, torch.tensor([0, 4]))  # (2, h, w, 9), the windows of frames 2 and 6
    want = ref.window_inputs(torch.from_numpy(rgb), torch.tensor([0, 4])).permute(0, 2, 3, 1)
    assert torch.allclose(x, want, rtol=0, atol=1e-7)
    # frame 6's window starts with frame 6's blue channel
    assert torch.allclose(x[1, ..., 0], torch.from_numpy(rgb[6, ..., 2]).float() / 255.0,
                          rtol=0, atol=1e-7)


def test_run_staged_rows_equal_the_reference(tmp_path):
    sd = weights_v1.state(11, "cpu")
    weights_v1.set_detector(sd, DETECTOR)
    path = weights_v1.write_checkpoint(str(tmp_path / "v1.pt"), sd, H, W)
    p = tinf.TrackNetPredictor(path, batch_size=B, device="cpu")
    assert p.arch == "TrackNetV1" and (p.h, p.w) == (H, W) and p.eval_mode == "sliding"
    T, src = 30, (1280, 720)
    yuv = scene.yuv_pool(12, 60, H, W, "cpu")[17:17 + T]
    staged = p.finalize_staged(p.upload_staged(yuv, src_wh=src, yuv=True))
    profiling.reset()
    with torch.profiler.profile():
        pred = p.run_staged(staged)
        spans = profiling.recorded()["spans"]
    want = ref.clip_rows(torch.from_numpy(yuv), {"height": H, "width": W}, src, sd)
    for k in ("X", "Y", "Visibility"):
        assert pred[k] == want[k].tolist(), k
    assert pred["Frame"] == list(range(T))
    assert pred["Visibility"][:2] == [0, 0] and sum(pred["Visibility"]) >= T - 8
    chunks = -(-(T - 2) // B)
    assert spans["serve::classify"]["n"] == chunks and spans["serve::decode"]["n"] == chunks
    os.remove(path)


def test_short_clips_are_all_invisible(v1_ckpt):
    p = tinf.TrackNetPredictor(v1_ckpt[0], batch_size=B, device="cpu")
    for T in (1, 2, 3):
        frames = np.zeros((T, 32, 64, 3), np.uint8)
        pred = p.run_staged(p.stage_frames(frames))
        assert pred["Frame"] == list(range(T)) and len(pred["Visibility"]) == T
        assert pred["Visibility"][:2] == [0] * min(T, 2)


def test_checkpoint_round_trip(v1_ckpt):
    path, model = v1_ckpt
    loaded, pd = load_model_from_checkpoint(path)
    assert pd["model_name"] == "TrackNetV1" and type(loaded).__name__ == "TrackNetV1"
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    with np.load(path) as z:
        assert z["model/params/conv18/conv/kernel"].shape == (3, 3, 64, 256)
        assert z["model/batch_stats/conv1/bn/var"].shape == (64,)


@pytest.mark.parametrize("wrapped", [False, True])
def test_converter_takes_a_ball_tracker_state_dict(tmp_path, wrapped):
    net = ref.BallTrackerNet()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(0, 1, generator=g)
                m.running_var.uniform_(0.5, 2, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.5, 0.5, generator=g)
    src, out = str(tmp_path / "model_best.pt"), str(tmp_path / "TrackNetV1_best.pt")
    torch.save({"model": net.state_dict()} if wrapped else net.state_dict(), src)
    conv.main(["--in", src, "--out", out])
    model, pd = load_model_from_checkpoint(out)
    assert pd == {"model_name": "TrackNetV1", "seq_len": 3, "bg_mode": "", "height": 360,
                  "width": 640}
    x = torch.rand((1, 9, 32, 64), generator=g)
    net.eval()
    with torch.no_grad():
        want = net(x).reshape(1, 256, 32, 64)
        assert torch.equal(model.eval()(x), want)
        got = ref.logits(net.state_dict(), x)  # its BatchNorm formula rounds otherwise
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    bad = {k: v for k, v in net.state_dict().items()}
    bad["conv1.block.0.weight"] = torch.zeros((64, 27, 3, 3))
    torch.save(bad, src)
    with pytest.raises(ValueError, match="takes 27 channels"):
        conv.main(["--in", src, "--out", out])


def _write_clip(path, n):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (128, 64))
    base = np.random.default_rng(4).integers(30, 90, (64, 128, 3), np.uint8)
    for t in range(n):
        f = base.copy()
        f[20:28, 8 + 4 * t: 16 + 4 * t] = 255
        vw.write(f)
    vw.release()


def test_predict_cli_serves_a_v1_checkpoint_without_a_flag(v1_ckpt, tmp_path):
    clip = str(tmp_path / "clip.mp4")
    _write_clip(clip, 9)
    predict_cli.main(["--video_file", clip, "--tracknet_file", v1_ckpt[0], "--device", "cpu",
                      "--save_dir", str(tmp_path / "a"), "--cv2_decode", "--batch_size", "4"])
    with open(tmp_path / "a" / "clip_ball.csv") as f:
        rows = f.read().splitlines()
    assert rows[0] == "Frame,Visibility,X,Y" and len(rows) == 10
    assert rows[1].startswith("0,0,") and rows[2].startswith("1,0,")
    # --eval_mode is not read for a TrackNetV1 checkpoint
    predict_cli.main(["--video_file", clip, "--tracknet_file", v1_ckpt[0], "--device", "cpu",
                      "--save_dir", str(tmp_path / "b"), "--cv2_decode", "--batch_size", "4",
                      "--eval_mode", "nonoverlap"])
    with open(tmp_path / "b" / "clip_ball.csv") as f:
        assert f.read().splitlines() == rows


def test_unported_paths_raise_for_v1(v1_ckpt, tmp_path):
    clip = str(tmp_path / "clip.mp4")
    _write_clip(clip, 5)
    for kw in ({"large_video": True}, {"device_resize": True}):
        with pytest.raises(NotImplementedError, match="TrackNetV1"):
            tinf.predict_video(clip, v1_ckpt[0], device="cpu", native_decode=False, **kw)
    with pytest.raises(ValueError, match="without InpaintNet"):
        tinf.TrackNetPredictor(v1_ckpt[0], v1_ckpt[0], device="cpu")
