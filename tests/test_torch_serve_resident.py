"""The port's device-resize serving path against the JAX package's on the
CPU, both at float32 (``tests/torch_serving_data.py``):

- ``predict_frames`` (raw frames padded on the device, resized there with
  PIL's bicubic, B+L-1 windows a chunk through the stateless ensemble):
  equal rows in ``weight`` and ``nonoverlap``, for ``concat`` and
  ``subtract`` (the difference taken at source resolution), over a clip
  of 19 frames (full chunks and a partial one);
- ``median_of_resident``: equal, over all frames and sampled;
- ``stage_resident``'s padding: L-1 copies of frame 0, the frames, copies
  of the last frame;
- ``predict_video(device_resize=True)``: the CSV of the JAX
  ``predict_video``, byte for byte.
"""

import numpy as np
import pytest
import shutil

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import tracknetv3_tpu.inference as jinf  # noqa: E402
from tests.torch_serving_data import (  # noqa: E402
    B, H, JAX_F32, L, W, csv_text, detecting_checkpoint, inpaint_checkpoint, jax_predictor,
    port_predictor, read_rgb, visible, write_clip,
)
from tracknetv3_tpu_torch import inference as tinf  # noqa: E402

T = 19


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("resident")
    clip = write_clip(str(d / "clip.mp4"), T, seed=5)
    tns = {bg: detecting_checkpoint(str(d / f"tn_{bg}.pt"), bg, clip)
           for bg in ("concat", "subtract")}
    yield clip, tns, inpaint_checkpoint(str(d / "inp.pt"))
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each


@pytest.mark.parametrize("bg_mode", ["concat", "subtract"])
@pytest.mark.parametrize("eval_mode", ["weight", "nonoverlap"])
def test_predict_frames_matches_jax(data, bg_mode, eval_mode):
    clip, tns, _ = data
    frames = read_rgb(clip)
    want = jax_predictor(tns[bg_mode], eval_mode).predict_frames(frames, img_scaler=(2.0, 2.0))
    got = port_predictor(tns[bg_mode], eval_mode).predict_frames(frames, img_scaler=(2.0, 2.0))
    assert got == want
    assert got["Frame"] == list(range(T))
    assert visible(got) > 0  # the comparison sees detections


@pytest.mark.parametrize("max_sample_num", [None, 5])
def test_median_of_resident_matches_jax(data, max_sample_num):
    clip, tns, _ = data
    frames = read_rgb(clip)
    jp, tp = jax_predictor(tns["concat"]), port_predictor(tns["concat"])
    jbuf, jmeta = jp.stage_frames(frames)
    want = np.asarray(jp.median_of_resident(jbuf, jmeta["T"], max_sample_num))
    buf, n = tp.stage_resident(frames)
    got = tp.median_of_resident(buf, n, max_sample_num).numpy()
    np.testing.assert_array_equal(got, want)


def test_stage_resident_pads_with_the_end_frames(data):
    clip, tns, _ = data
    frames = read_rgb(clip)
    tp = port_predictor(tns["concat"], batch_size=B)
    buf, n = tp.stage_resident(frames)
    assert n == T and buf.shape[0] == (L - 1) + -(-T // B) * B + (L - 1)
    want = np.concatenate([frames[:1].repeat(L - 1, 0), frames,
                           frames[-1:].repeat(buf.shape[0] - (L - 1) - T, 0)])
    np.testing.assert_array_equal(buf.numpy(), want)
    # the JAX buffer (padded to a 256-frame bucket) holds the same frames first
    jbuf, _ = jax_predictor(tns["concat"]).stage_frames(frames)
    np.testing.assert_array_equal(np.asarray(jbuf)[: buf.shape[0]], want)
    with pytest.raises(ValueError, match="zero frames"):
        tp.stage_resident(frames[:0])
    with pytest.raises(ValueError, match="uint8"):
        tp.stage_resident(frames.astype(np.float32))


@pytest.mark.parametrize("eval_mode", ["weight", "nonoverlap"])
def test_predict_video_device_resize_csv_matches_jax(data, tmp_path, eval_mode, monkeypatch):
    clip, tns, inp = data
    monkeypatch.setattr(jinf, "TrackNetPredictor", JAX_F32)
    jinf.predict_video(clip, tns["concat"], inp, eval_mode=eval_mode, batch_size=B,
                       device_resize=True, save_dir=str(tmp_path / "jax"), input_hw=(H, W),
                       native_decode=False)
    pred = tinf.predict_video(clip, tns["concat"], inp, eval_mode=eval_mode, batch_size=B,
                              device_resize=True, save_dir=str(tmp_path / "port"),
                              input_hw=(H, W), device="cpu", compute_dtype=torch.float32)
    assert (csv_text(tmp_path / "port" / "clip_ball.csv")
            == csv_text(tmp_path / "jax" / "clip_ball.csv"))
    assert len(pred["Frame"]) == T and visible(pred) > 0
