"""The port's streaming and batch serving with the native decoder against
the JAX package's, on the CPU (float32, 32x64, seq_len 3, batch 4; clips
and checkpoints from ``tests/torch_serving_data.py``), both packages at
their default ``native_decode=True``, ``stage_format="auto"``:

- ``predict_video_streaming`` (host resize) in ``bg_mode`` ``''`` and
  ``concat``, ``weight`` and ``nonoverlap``: the native branch (RGB at
  model resolution, read in batches of 64) gives the JAX package's rows and
  ``decode_backend``; ``subtract`` keeps cv2 in both;
- ``predict_videos`` over three clips in YUV420 waves under a budget that
  makes two: the JAX package's rows and waves (its buckets one frame wide),
  each video's upload in YUV420.
"""

import pytest
import shutil

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import tracknetv3_tpu.inference as jinf  # noqa: E402
from tests.torch_serving_data import (  # noqa: E402
    B, H, JAX_F32, W, detecting_checkpoint, visible, write_clip,
)
from tracknetv3_tpu_torch import inference as tinf  # noqa: E402

T = 21
FB = H * W * 3  # bytes of one model-resolution frame: the wave rule's, whatever the format


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_serving")
    clip = write_clip(str(d / "clip.mp4"), T, seed=12)
    tns = {bg: detecting_checkpoint(str(d / f"tn_{bg or 'rgb'}.pt"), bg, clip)
           for bg in ("", "concat", "subtract")}
    clips = [write_clip(str(d / f"b{n}.mp4"), n, seed=n) for n in (10, 13, 8)]
    yield clip, tns, clips
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each


def _predictors(tn, eval_mode="weight"):
    kw = dict(eval_mode=eval_mode, batch_size=B, input_hw=(H, W))
    return (JAX_F32(tn, **kw),
            tinf.TrackNetPredictor(tn, compute_dtype=torch.float32, device="cpu", **kw))


@pytest.mark.parametrize("bg_mode,eval_mode,backend", [
    ("", "weight", "native-lowres1"), ("concat", "weight", "native-lowres1"),
    ("concat", "nonoverlap", "native-lowres1"), ("subtract", "weight", "cv2"),
])
def test_streaming_native_branch_matches_jax(data, bg_mode, eval_mode, backend):
    clip, tns, _ = data
    jp, tp = _predictors(tns[bg_mode], eval_mode)
    want = jp.predict_video_streaming(clip)
    got = tp.predict_video_streaming(clip)
    assert got == want
    assert tp.decode_backend == jp.decode_backend == backend
    assert got["Frame"] == list(range(T)) and visible(got) > 0


def test_streaming_native_branch_differs_from_cv2(data):
    """The native branch is taken: libswscale's scale is not cv2's
    ``INTER_AREA``, so the staged frames, and here some rows, differ."""
    clip, tns, _ = data
    _, tp = _predictors(tns[""])
    native = tp.predict_video_streaming(clip)
    tp.native_decode = False
    cv2_rows = tp.predict_video_streaming(clip)
    assert tp.decode_backend == "cv2"
    assert native != cv2_rows


def test_predict_videos_yuv420_waves_match_jax(data):
    _, tns, clips = data
    jp, tp = _predictors(tns["concat"])
    uploads = []
    real = tp.upload_video

    def recording(f):
        up = real(f)
        uploads.append((up.yuv, tuple(up.buf.shape)))
        return up

    tp.upload_video = recording
    stats, jstats = {}, {}
    got = tinf.predict_videos(clips, "", predictor=tp, staging_budget_bytes=2 * 21 * FB,
                              stats=stats)
    want = jinf.predict_videos(clips, "", predictor=jp, staging_budget_bytes=2 * 21 * FB,
                               bucket_quantum=1, stats=jstats)
    assert got == want
    assert [w["videos"] for w in stats["waves"]] == [w["videos"] for w in jstats["waves"]] == [
        clips[:1], clips[1:]]
    assert [w["buckets"] for w in stats["waves"]] == [[10], [13, 8]]
    assert uploads == [(True, (n, H * W * 3 // 2)) for n in (10, 13, 8)]
    assert tp.decode_backend == jp.decode_backend == "native-lowres1+yuv420"
    assert all(visible(got[f]) > 0 for f in clips)
