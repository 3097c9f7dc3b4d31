"""The port's streaming path (``--large_video``) against the JAX package's
on the CPU, both at float32 with cv2 decode (``tests/torch_serving_data.py``):

- ``predict_video_streaming``: equal rows with the host resize (cv2
  ``INTER_AREA``, the median resized from uint8) and without (raw frames
  resized on the device), in ``weight`` and ``nonoverlap``; ``subtract``
  (the mod-256 difference at source resolution) both ways;
- ``VideoReader.sample_median``: the JAX reader's values, over the whole
  clip and over a ``video_range`` of seconds at a sampling stride, and so
  does the streaming path's median of ``sample_frames`` taken in slabs of
  rows (``median_of_host_frames``);
- ``predict_video(large_video=True, video_range=...)``: the JAX CSV, byte
  for byte;
- a reader that fails mid-stream raises ``RuntimeError`` and no CSV is
  written; a container that counts more frames than decode stops
  gracefully, with the JAX package's rows;
- the producer thread of the pipeline (``_prefetched``): its items, then
  its error; stopped and joined when the consumer leaves early.
"""

import itertools
import os
import threading
import time

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import tracknetv3_tpu.inference as jinf  # noqa: E402
from tests.torch_serving_data import (  # noqa: E402
    B, H, JAX_F32, PORT_ARGS, W, csv_text, detecting_checkpoint, jax_predictor, port_predictor,
    visible, write_clip,
)
from tracknetv3_tpu_torch import inference as tinf  # noqa: E402
from tracknetv3_tpu_torch.ops import preprocess as tpre  # noqa: E402
from tracknetv3_tpu_torch.utils.io import VideoReader  # noqa: E402

T = 21
FPS = 10  # so that whole seconds cut the clip


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    clip = write_clip(str(d / "clip.mp4"), T, seed=6, fps=FPS)
    tns = {bg: detecting_checkpoint(str(d / f"tn_{bg}.pt"), bg, clip)
           for bg in ("concat", "subtract")}
    return clip, tns


@pytest.mark.parametrize("bg_mode,eval_mode,host_resize", [
    ("concat", "weight", True), ("concat", "weight", False),
    ("concat", "nonoverlap", True), ("concat", "nonoverlap", False),
    ("subtract", "weight", True), ("subtract", "weight", False),
])
def test_predict_video_streaming_matches_jax(data, bg_mode, eval_mode, host_resize):
    clip, tns = data
    want = jax_predictor(tns[bg_mode], eval_mode).predict_video_streaming(
        clip, host_resize=host_resize)
    got = port_predictor(tns[bg_mode], eval_mode).predict_video_streaming(
        clip, host_resize=host_resize)
    assert got == want
    assert got["Frame"] == list(range(T))
    assert visible(got) > 0


@pytest.mark.parametrize("max_sample_num,video_range", [(1800, None), (4, (1, 2)), (3, (0, 9))])
def test_sample_median_matches_jax(data, monkeypatch, max_sample_num, video_range):
    clip, _ = data
    jr, tr = jinf.VideoReader(clip), VideoReader(clip)
    try:
        want = jr.sample_median(max_sample_num, video_range)
        got = tr.sample_median(max_sample_num, video_range)
        frames = tr.sample_frames(max_sample_num, video_range)
    finally:
        jr.release()
        tr.release()
    assert got.dtype == np.float32 and got.shape == (2 * H, 2 * W, 3)
    np.testing.assert_array_equal(got, want)
    # 5 rows a slab: 13 slabs of the 64 rows, the last one short
    monkeypatch.setattr(tpre, "MEDIAN_SLAB_BYTES", 5 * frames[:, 0].nbytes)
    slabs = tpre.median_of_host_frames(frames, torch.device("cpu"))
    assert slabs.dtype == np.float32
    np.testing.assert_array_equal(slabs, want)


def test_predict_video_large_video_csv_matches_jax(data, tmp_path, monkeypatch):
    clip, tns = data
    monkeypatch.setattr(jinf, "TrackNetPredictor", JAX_F32)
    jinf.predict_video(clip, tns["concat"], batch_size=B, large_video=True, video_range=(1, 2),
                       save_dir=str(tmp_path / "jax"), input_hw=(H, W), native_decode=False)
    pred = tinf.predict_video(clip, tns["concat"], batch_size=B, large_video=True,
                              video_range=(1, 2), save_dir=str(tmp_path / "port"),
                              input_hw=(H, W), device="cpu", compute_dtype=torch.float32)
    assert (csv_text(tmp_path / "port" / "clip_ball.csv")
            == csv_text(tmp_path / "jax" / "clip_ball.csv"))
    assert len(pred["Frame"]) == T and visible(pred) > 0


class FailingReader(VideoReader):
    """Raises while decoding frame 10 in a run of reads (a read right after
    a seek, as the median's sampling makes, succeeds)."""

    sought = False

    def seek(self, frame_idx):
        self.sought = True
        super().seek(frame_idx)

    def read(self):
        if not self.sought and int(self.cap.get(cv2.CAP_PROP_POS_FRAMES)) == 10:
            raise OSError("corrupt packet at frame 10")
        self.sought = False
        return super().read()


@pytest.mark.parametrize("host_resize", [True, False])
def test_failing_reader_raises_and_writes_no_csv(data, tmp_path, monkeypatch, host_resize):
    clip, tns = data
    monkeypatch.setattr(tinf, "open_video", FailingReader)
    p = port_predictor(tns["concat"])
    with pytest.raises(RuntimeError, match="video decode failed mid-stream") as e:
        p.predict_video_streaming(clip, host_resize=host_resize)
    assert isinstance(e.value.__cause__, OSError)
    with pytest.raises(RuntimeError, match="video decode failed mid-stream"):
        tinf.predict_video(clip, tns["concat"], large_video=True, save_dir=str(tmp_path),
                           **PORT_ARGS)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("eval_mode", ["weight", "nonoverlap"])
def test_overcounting_container_stops_like_jax(data, monkeypatch, eval_mode):
    """A container that counts 9 frames more than decode (a corrupt or
    variable-rate tail): the stream stops where the frames do."""
    clip, tns = data

    def overcounting(base):
        class Reader(base):
            def __init__(self, path):
                super().__init__(path)
                self.video_len += 9
        return Reader

    monkeypatch.setattr(jinf, "VideoReader", overcounting(jinf.VideoReader))
    monkeypatch.setattr(tinf, "open_video", overcounting(VideoReader))
    want = jax_predictor(tns["concat"], eval_mode).predict_video_streaming(clip)
    got = port_predictor(tns["concat"], eval_mode).predict_video_streaming(clip)
    assert got == want
    assert T <= len(got["Frame"]) <= T + 9


def test_prefetched_hands_over_its_items_then_the_producer_error():
    def items():
        yield 0
        yield 1
        raise OSError("corrupt packet")

    got = []
    with pytest.raises(RuntimeError, match="decode failed") as e:
        for item in tinf._prefetched(items(), "decode failed", depth=1):
            got.append(item)
    assert got == [0, 1] and isinstance(e.value.__cause__, OSError)


def test_prefetched_stops_its_producer_when_the_consumer_leaves():
    made = []

    def endless():
        for i in itertools.count():
            made.append(i)
            yield i

    before = threading.active_count()
    it = tinf._prefetched(endless(), "x", depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()  # the consumer leaves: the producer is stopped and joined
    assert threading.active_count() == before
    n = len(made)
    time.sleep(0.2)
    assert len(made) == n <= 3 + 2 + 2  # read ahead by at most the queue and one in hand
