"""The port's batch serving (``predict_videos``, ``--video_dir``) on the
CPU, as ``tests/test_staged.py`` holds the JAX package's, and against the
JAX ``predict_videos`` (both at float32, cv2 decode;
``tests/torch_serving_data.py``):

- per-video rows equal to single-video serving on the same predictor and
  to the JAX package's, one CSV per video;
- a corrupt file is skipped under ``on_error="skip"`` and raised under
  ``"raise"``;
- the wave accounting by the port's byte rule (real frame counts, no
  buckets), a solo video over half the budget holding two slots, a video
  over the budget streaming, and a second call on the same predictor;
- a first video whose upload fails gives its slots back, and a failure
  while serving stops the producer (under a timeout, so that a deadlock
  fails instead of hanging);
- the JAX package's TPU options raise; the native decoder, the staging
  format and ``num_devices``, which the port took since, run.
"""

import shutil
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import tracknetv3_tpu.inference as jinf  # noqa: E402
from tests.torch_serving_data import (  # noqa: E402
    H, PORT_ARGS, W, csv_text, detecting_checkpoint, inpaint_checkpoint, jax_predictor,
    port_predictor, visible, write_clip,
)
from tracknetv3_tpu_torch import inference as tinf  # noqa: E402

FB = H * W * 3  # bytes of one model-resolution frame


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("batch")
    clips = {T: write_clip(str(d / f"clip{T}.mp4"), T, seed=T) for T in (9, 10, 17, 20, 30, 50)}
    tn = detecting_checkpoint(str(d / "tn.pt"), "concat", clips[17])
    bad = str(d / "bad.mp4")
    with open(bad, "wb") as f:
        f.write(b"not a video at all")
    yield clips, tn, inpaint_checkpoint(str(d / "inp.pt")), bad
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each


def _single(clips, tn, inp=""):
    """Each clip served alone by ``predict_video``."""
    return {f: tinf.predict_video(f, tn, inp, **PORT_ARGS) for f in clips}


def test_predict_videos_matches_single_and_jax(data, tmp_path):
    clips, tn, inp, _ = data
    files = [clips[10], clips[17]]
    p = port_predictor(tn, inp=inp)
    got = tinf.predict_videos(files, "", predictor=p, save_dir=str(tmp_path / "port"))
    assert got == _single(files, tn, inp)
    want = jinf.predict_videos(files, "", predictor=jax_predictor(tn, inp=inp),
                               save_dir=str(tmp_path / "jax"))
    assert got == want
    for f, T in zip(files, (10, 17)):
        assert len(got[f]["Frame"]) == T
        name = f"clip{T}_ball.csv"
        assert csv_text(tmp_path / "port" / name) == csv_text(tmp_path / "jax" / name)
    assert sum(visible(v) for v in got.values()) > 0


def test_predict_videos_skips_or_raises_a_corrupt_file(data):
    clips, tn, _, bad = data
    p = port_predictor(tn)
    got = tinf.predict_videos([bad, clips[9]], "", predictor=p, on_error="skip")
    assert list(got) == [clips[9]] and len(got[clips[9]]["Frame"]) == 9
    with pytest.raises(Exception):
        tinf.predict_videos([bad, clips[9]], "", predictor=p)  # on_error="raise"


def test_predict_videos_wave_accounting_and_reuse(data):
    """A wave budget of 48 frames puts 10 + 17 + 9 frames in the first wave
    and 20 in the second, each holding one slot; a second call on the same
    predictor repeats the rows and the waves; a budget that admits
    everything makes one wave."""
    clips, tn, _, _ = data
    files = [clips[10], clips[17], clips[9], clips[20]]
    p = port_predictor(tn)
    want = _single(files, tn)
    stats = {}
    got = tinf.predict_videos(files, "", predictor=p, staging_budget_bytes=2 * 48 * FB,
                              stats=stats)
    assert got == want
    assert [w["videos"] for w in stats["waves"]] == [files[:3], files[3:]]
    assert [w["buckets"] for w in stats["waves"]] == [[10, 17, 9], [20]]
    assert [w["slots"] for w in stats["waves"]] == [1, 1]
    assert stats["streaming"] == []
    again = {}
    assert tinf.predict_videos(files, "", predictor=p, staging_budget_bytes=2 * 48 * FB,
                               stats=again) == want
    assert again == stats
    one = {}
    assert tinf.predict_videos(files, "", predictor=p, staging_budget_bytes=2 * 1000 * FB,
                               stats=one) == want
    assert [w["videos"] for w in one["waves"]] == [files]


def test_predict_videos_solo_oversized_and_streaming(data):
    """A budget of 40 frames: 10 frames wave alone (the next is solo), 30
    frames (over half the budget) run alone in a wave of two slots, 50
    frames (over the budget) stream; the rows match the JAX package's."""
    clips, tn, _, _ = data
    files = [clips[10], clips[30], clips[50]]
    stats = {}
    got = tinf.predict_videos(files, "", predictor=port_predictor(tn),
                              staging_budget_bytes=40 * FB, stats=stats)
    assert [w["videos"] for w in stats["waves"]] == [[files[0]], [files[1]]]
    assert [w["slots"] for w in stats["waves"]] == [1, 2]
    assert stats["streaming"] == [files[2]]
    jstats = {}
    want = jinf.predict_videos(files, "", predictor=jax_predictor(tn), bucket_quantum=10,
                               staging_budget_bytes=40 * FB, stats=jstats)
    assert jstats["streaming"] == [files[2]]
    assert got == want
    assert [len(got[f]["Frame"]) for f in files] == [10, 30, 50]


def _within(seconds, fn):
    """fn() in a thread that must end within ``seconds``: a deadlock fails."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def test_failing_first_video_returns_its_slots(data):
    clips, tn, _, _ = data
    files = [clips[10], clips[9], clips[17]]
    p = port_predictor(tn)
    real_upload = p.upload_video

    def flaky_upload(f):
        if f == files[0]:
            raise RuntimeError("injected upload failure")
        return real_upload(f)

    p.upload_video = flaky_upload
    stats = {}
    got = _within(120, lambda: tinf.predict_videos(files, "", predictor=p, stats=stats,
                                                   on_error="skip"))
    assert sorted(got) == sorted(files[1:])
    assert [w["videos"] for w in stats["waves"]] == [files[1:]]
    assert len(got[files[1]]["Frame"]) == 9
    with pytest.raises(RuntimeError, match="injected upload failure"):
        _within(120, lambda: tinf.predict_videos(files, "", predictor=p))


def test_a_failure_while_serving_stops_the_producer(data):
    """Under ``on_error="raise"`` a video that fails on the card (here its
    ``run_staged``) raises while the producer still has waves to upload:
    the producer stops instead of waiting for slots nobody returns."""
    clips, tn, _, _ = data
    files = [clips[9], clips[10], clips[17], clips[20], clips[30]]
    p = port_predictor(tn)

    def failing_run(staged, img_scaler=None, mesh=None):
        raise RuntimeError("injected serving failure")

    p.run_staged = failing_run
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="injected serving failure"):
        _within(120, lambda: tinf.predict_videos(files, "", predictor=p,
                                                 staging_budget_bytes=2 * 12 * FB))
    assert threading.active_count() == before


@pytest.mark.parametrize("option", [
    dict(bucket_quantum=256), dict(num_devices=2), dict(native_decode=True),
    dict(stage_format="yuv420"), dict(program_cache_dir="x"), dict(on_error="ignore"),
])
def test_predict_videos_refuses_the_tpu_options(data, option, tmp_path):
    """The TPU options raise; ``native_decode`` and ``stage_format``, ported
    since, serve the clip (the forced ``yuv420`` staging YUV420 rows), and
    ``num_devices=2`` serves it on a 2-entry CPU mesh: the rows and the CSV
    of the single device."""
    clips, tn, _, _ = data
    if "num_devices" in option:
        p = port_predictor(tn)
        want = tinf.predict_videos([clips[9]], "", predictor=p, save_dir=str(tmp_path / "one"))
        got = tinf.predict_videos([clips[9]], "", predictor=p, save_dir=str(tmp_path / "two"),
                                  **option)
        assert got == want and len(got[clips[9]]["Frame"]) == 9
        assert (csv_text(tmp_path / "two" / "clip9_ball.csv")
                == csv_text(tmp_path / "one" / "clip9_ball.csv"))
        return
    if set(option) <= {"native_decode", "stage_format"}:
        p = tinf.TrackNetPredictor(tn, input_hw=(H, W), device="cpu", batch_size=4, **option)
        got = tinf.predict_videos([clips[9]], tn, predictor=p)
        assert len(got[clips[9]]["Frame"]) == 9
        assert p.decode_backend == "native-lowres1+yuv420"
        return
    with pytest.raises(ValueError if "on_error" in option else NotImplementedError):
        tinf.predict_videos([clips[9]], tn, device="cpu", **option)
