"""The port's staged serving path with the native decoder and YUV420
staging against the JAX package's, on the CPU (float32, 32x64, seq_len 3,
batch 4; clips and checkpoints from ``tests/torch_serving_data.py``):

- ``predict_video`` of both packages with their default flags
  (``native_decode=True``, ``stage_format="auto"``) on a cv2-written mpeg4
  clip and on an h264 clip: the same CSV byte for byte and the same
  ``decode_backend`` (``native-lowres1+yuv420``, ``native-lowres0+yuv420``);
  so under ``stage_format="yuv420"``, ``"bgr"`` and ``native_decode=False``;
- the staged buffer and median of a YUV420 upload in slabs that split the
  video: bit-equal to the JAX package's;
- a forced ``yuv420`` at an odd model width raises the JAX package's
  ``RuntimeError``, where ``auto`` stages the native reader's packed BGR
  (equal to the JAX slabs); a ``yuv`` flag that does not match the layout
  raises ``ValueError``; with the library missing, ``auto`` decodes with
  cv2 (the JAX ``native_decode=False`` rows) and ``yuv420`` raises; a
  decode error mid-stream raises ``RuntimeError`` from it.
"""

import numpy as np
import pytest
import shutil

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import tracknetv3_tpu.inference as jinf  # noqa: E402
from tests.torch_serving_data import (  # noqa: E402
    B, H, JAX_F32, W, csv_text, detecting_checkpoint, inpaint_checkpoint, visible, write_clip,
)
from tracknetv3_tpu import native_video as jax_native_video  # noqa: E402
from tracknetv3_tpu_torch import inference as tinf  # noqa: E402
from tracknetv3_tpu_torch import native_video  # noqa: E402

T = 17


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_staging")
    clips = {"mpeg4": write_clip(str(d / "clip.mp4"), T, seed=8)}
    h264 = str(d / "clip_h264.mp4")
    assert native_video.write_test_clip(h264, "libx264", n=T, w=2 * W, h=2 * H)
    clips["h264"] = h264
    tn = detecting_checkpoint(str(d / "tn.pt"), "concat", clips["mpeg4"])
    yield clips, tn, inpaint_checkpoint(str(d / "inp.pt"))
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each


def _recording(make, made):
    def record(*args, **kwargs):
        p = make(*args, **kwargs)
        made.append(p)
        return p
    return record


def _both(monkeypatch, clip, tn, inp, tmp_path, **kw):
    """(port CSV, JAX CSV, port decode_backend, JAX decode_backend) of
    ``predict_video`` with ``kw`` on both sides."""
    made_j, made_t = [], []
    monkeypatch.setattr(jinf, "TrackNetPredictor", _recording(JAX_F32, made_j))
    monkeypatch.setattr(tinf, "TrackNetPredictor", _recording(tinf.TrackNetPredictor, made_t))
    jinf.predict_video(clip, tn, inp, batch_size=B, input_hw=(H, W), bucket_quantum=16,
                       save_dir=str(tmp_path / "jax"), **kw)
    pred = tinf.predict_video(clip, tn, inp, batch_size=B, input_hw=(H, W), device="cpu",
                              compute_dtype=torch.float32, save_dir=str(tmp_path / "port"), **kw)
    assert len(pred["Frame"]) >= T - 1 and visible(pred) > 0
    name = clip.rsplit("/", 1)[-1][:-4] + "_ball.csv"
    return (csv_text(tmp_path / "port" / name), csv_text(tmp_path / "jax" / name),
            made_t[0].decode_backend, made_j[0].decode_backend)


@pytest.mark.parametrize("codec,backend", [("mpeg4", "native-lowres1+yuv420"),
                                           ("h264", "native-lowres0+yuv420")])
def test_predict_video_default_flags_match_jax(data, monkeypatch, tmp_path, codec, backend):
    """Both packages' defaults stage the same pixels: the CSVs are equal."""
    clips, tn, inp = data
    got, want, got_backend, want_backend = _both(monkeypatch, clips[codec], tn, inp, tmp_path)
    assert got == want
    assert got_backend == want_backend == backend


@pytest.mark.parametrize("kw,backend", [
    (dict(stage_format="yuv420"), "native-lowres1+yuv420"),
    (dict(stage_format="bgr"), "native-lowres1"),
    (dict(native_decode=False), "cv2"),
])
def test_predict_video_decode_options_match_jax(data, monkeypatch, tmp_path, kw, backend):
    clips, tn, _ = data
    got, want, got_backend, want_backend = _both(monkeypatch, clips["mpeg4"], tn, "", tmp_path,
                                                 **kw)
    assert got == want
    assert got_backend == want_backend == backend


def _port(tn, **kw):
    kw = dict(dict(batch_size=B, input_hw=(H, W), compute_dtype=torch.float32, device="cpu"),
              **kw)
    return tinf.TrackNetPredictor(tn, **kw)


def test_yuv_staged_buffer_in_slabs_matches_jax(data):
    clips, tn, _ = data
    p = _port(tn)
    up = p.upload_video(clips["mpeg4"], slab_frames=4)  # 5 slabs, the last of 1 frame
    assert up.yuv and tuple(up.buf.shape) == (T, H * W * 3 // 2)
    assert up.src_wh == (2 * W, 2 * H)  # full size under lowres 1
    staged = p.finalize_staged(up)
    assert staged.bgr is False and p.decode_backend == "native-lowres1+yuv420"

    jp = JAX_F32(tn, batch_size=B, input_hw=(H, W))
    slabs, src_wh, yuv = jp.upload_video_slabs(clips["mpeg4"], slab_frames=4)
    want = jp.finalize_staged(slabs, bgr=True, src_wh=src_wh, yuv=yuv)
    assert yuv and src_wh == up.src_wh and want.bgr is False
    np.testing.assert_array_equal(staged.buf.numpy(), np.asarray(want.buf))
    np.testing.assert_array_equal(staged.median.numpy(), np.asarray(want.median))
    assert p.run_staged(staged) == jp.run_staged(want)


def test_forced_yuv420_at_odd_dims_raises_as_jax(data):
    clips, tn, _ = data
    hw = (H, W - 1)  # an odd model width
    p = _port(tn, input_hw=hw, stage_format="yuv420")
    with pytest.raises(RuntimeError, match="cannot be honored") as got:
        p.upload_video(clips["mpeg4"])
    jp = jinf.TrackNetPredictor(tn, input_hw=hw, stage_format="yuv420")
    with pytest.raises(RuntimeError) as want:
        jp.upload_video_slabs(clips["mpeg4"])
    assert str(got.value) == str(want.value)
    assert "model dims 32x63 are not even" in str(got.value)

    # "auto" stages the native reader's packed BGR there, as the JAX package does
    p = _port(tn, input_hw=hw)
    up = p.upload_video(clips["mpeg4"], slab_frames=5)
    jp = jinf.TrackNetPredictor(tn, input_hw=hw)
    slabs, _, yuv = jp.upload_video_slabs(clips["mpeg4"], slab_frames=5)
    assert not up.yuv and not yuv and up.bgr
    assert p.decode_backend == jp.decode_backend == "native-lowres1"
    np.testing.assert_array_equal(up.buf.numpy(), np.concatenate([np.asarray(s) for s in slabs]))


def test_layout_flag_must_match_the_staged_layout(data):
    clips, tn, _ = data
    p = _port(tn)
    up = p.upload_video(clips["mpeg4"])
    with pytest.raises(ValueError, match="does not match the staged layout"):
        p.finalize_staged(up._replace(yuv=False))
    bgr = _port(tn, stage_format="bgr").upload_video(clips["mpeg4"])
    with pytest.raises(ValueError, match="does not match the staged layout"):
        p.finalize_staged(bgr._replace(yuv=True))
    with pytest.raises(ValueError, match="stage_format must be"):
        _port(tn, stage_format="nv12")


def test_missing_library_auto_falls_back_to_cv2_and_yuv420_raises(data, monkeypatch, capfd):
    clips, tn, _ = data
    monkeypatch.setattr(native_video, "_lib", None)
    monkeypatch.setattr(native_video, "_build_failed", False)
    monkeypatch.setattr(native_video, "SOURCE", "missing_video_decode.cpp")  # nothing to build
    monkeypatch.setattr(jax_native_video, "_load", lambda: None)
    p = _port(tn)
    staged = p.finalize_staged(p.upload_video(clips["mpeg4"]))
    assert p.decode_backend == "cv2" and staged.bgr is True
    assert "videos decode with cv2" in capfd.readouterr().err
    jp = JAX_F32(tn, batch_size=B, input_hw=(H, W))
    want = jp.run_staged(jp.stage_video(clips["mpeg4"]))
    assert jp.decode_backend == "cv2"
    assert p.run_staged(staged) == want

    with pytest.raises(RuntimeError, match="native decoder is unavailable") as got:
        _port(tn, stage_format="yuv420").upload_video(clips["mpeg4"])
    with pytest.raises(RuntimeError) as jax_err:
        jinf.TrackNetPredictor(tn, input_hw=(H, W),
                               stage_format="yuv420").upload_video_slabs(clips["mpeg4"])
    assert str(got.value) == str(jax_err.value)


class _FailingReader:
    """The native reader, failing on its second read."""

    def __init__(self, reader):
        self.reader, self.reads = reader, 0

    def __getattr__(self, name):
        return getattr(self.reader, name)

    def read_into_yuv(self, out):
        self.reads += 1
        if self.reads == 2:
            raise RuntimeError("native video decode error (yuv420)")
        return self.reader.read_into_yuv(out)


def test_decode_error_mid_stream_raises(data, monkeypatch):
    clips, tn, _ = data
    opened = []

    def failing(*args, **kwargs):
        opened.append(_FailingReader(native_video.open_native_video(*args, **kwargs)))
        return opened[-1]

    monkeypatch.setattr(tinf, "open_native_video", failing)
    p = _port(tn)
    with pytest.raises(RuntimeError, match="video decode failed mid-stream") as e:
        p.upload_video(clips["mpeg4"], slab_frames=4)
    assert "decode error" in str(e.value.__cause__)
    assert opened[0].reads == 2 and opened[0].reader._h is None  # closed


def test_predict_video_odd_dims_yuv420_refused_by_entry_point(data):
    clips, tn, _ = data
    with pytest.raises(RuntimeError, match="cannot be honored"):
        tinf.predict_video(clips["mpeg4"], tn, batch_size=B, input_hw=(H, W - 1), device="cpu",
                           stage_format="yuv420")

