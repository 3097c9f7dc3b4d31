"""The port's predict CLI (``python -m tracknetv3_tpu_torch.predict``) on
the CPU with the JAX CLI's serving flags, against the JAX package
(``tests/torch_serving_data.py``; the CLI's model resolution cut to 32x64
and its predictor made at float32, as the JAX side's):

- ``--video_dir``: one CSV per video, each the JAX ``predict_videos``'s
  byte for byte; a corrupt file is skipped with ``Predicted n/N``,
  ``--fail_fast`` raises at it, ``SystemExit`` when every video fails;
- the JAX CLI's parser errors: exactly one of ``--video_file`` /
  ``--video_dir``, and ``--video_dir`` without ``--large_video`` /
  ``--device_resize``;
- ``--output_video --traj_len 4``: an mp4 whose decoded frames are those
  of the JAX ``write_pred_video`` on the same rows; ``write_pred_video``
  with labels against the JAX writer with a pandas frame.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import pandas as pd  # noqa: E402

import tracknetv3_tpu.inference as jinf  # noqa: E402
from tests.torch_serving_data import (  # noqa: E402
    B, H, W, csv_text, detecting_checkpoint, jax_predictor, read_rgb, write_clip,
)
from tracknetv3_tpu.utils.io import write_pred_video as jax_write_pred_video  # noqa: E402
from tracknetv3_tpu_torch import inference as tinf  # noqa: E402
from tracknetv3_tpu_torch import predict as predict_cli  # noqa: E402
from tracknetv3_tpu_torch.utils.io import write_pred_video  # noqa: E402


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    vids = d / "videos"
    vids.mkdir()
    clips = [write_clip(str(vids / f"rally{i}.mp4"), T, seed=30 + i)
             for i, T in enumerate((11, 14))]
    tn = detecting_checkpoint(str(d / "tn.pt"), "concat", clips[0])
    return str(vids), clips, tn


@pytest.fixture
def small_cli(monkeypatch):
    """The CLI at the test's model resolution, its predictor at float32."""
    monkeypatch.setattr(tinf, "HEIGHT", H)
    monkeypatch.setattr(tinf, "WIDTH", W)
    real = tinf.TrackNetPredictor
    monkeypatch.setattr(tinf, "TrackNetPredictor",
                        lambda *a, compute_dtype=None, **kw: real(
                            *a, compute_dtype=torch.float32, **kw))


def test_video_dir_writes_the_jax_csvs(data, tmp_path, small_cli, capsys):
    vids, clips, tn = data
    with open(os.path.join(vids, "broken.mkv"), "wb") as f:
        f.write(b"not a video")
    with open(os.path.join(vids, "notes.txt"), "w") as f:
        f.write("not a video either")
    try:
        got = predict_cli.main(["--video_dir", vids, "--tracknet_file", tn, "--device", "cpu",
                                "--batch_size", str(B), "--save_dir", str(tmp_path / "port")])
        assert "Predicted 2/3 videos (1 skipped" in capsys.readouterr().out
        with pytest.raises(Exception):
            predict_cli.main(["--video_dir", vids, "--tracknet_file", tn, "--device", "cpu",
                              "--fail_fast", "--save_dir", str(tmp_path / "ff")])
    finally:
        os.remove(os.path.join(vids, "broken.mkv"))
        os.remove(os.path.join(vids, "notes.txt"))
    assert sorted(got) == clips
    jinf.predict_videos(clips, "", predictor=jax_predictor(tn), save_dir=str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == ["rally0_ball.csv", "rally1_ball.csv"]
    for name in os.listdir(tmp_path / "jax"):
        assert csv_text(tmp_path / "port" / name) == csv_text(tmp_path / "jax" / name)


def test_video_dir_where_every_video_fails(data, tmp_path, small_cli):
    _, _, tn = data
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "a.mp4").write_bytes(b"not a video")
    with pytest.raises(SystemExit, match="all 1 videos failed"):
        predict_cli.main(["--video_dir", str(tmp_path / "in"), "--tracknet_file", tn,
                          "--device", "cpu", "--save_dir", str(tmp_path / "out")])
    with pytest.raises(FileNotFoundError, match="no videos"):
        predict_cli.main(["--video_dir", str(tmp_path / "out"), "--tracknet_file", tn,
                          "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    [],
    ["--video_file", "v.mp4", "--video_dir", "d"],
    ["--video_dir", "d", "--large_video"],
    ["--video_dir", "d", "--device_resize"],
    ["--video_file", "v.mp4", "--video_range", "0-5"],
])
def test_parser_errors(argv):
    with pytest.raises(SystemExit) as e:
        predict_cli.main(argv + ["--tracknet_file", "t.pt", "--device", "cpu"])
    assert e.value.code == 2


def _decoded(path):
    frames = read_rgb(path)
    assert frames.ndim == 4
    return frames


def test_output_video_frames_equal_jax_writer(data, tmp_path, small_cli):
    _, clips, tn = data
    pred = predict_cli.main(["--video_file", clips[1], "--tracknet_file", tn, "--device", "cpu",
                             "--batch_size", str(B), "--output_video", "--traj_len", "4",
                             "--save_dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["rally1.mp4", "rally1_ball.csv"]
    jax_write_pred_video(clips[1], pred, str(tmp_path / "jax.mp4"), traj_len=4)
    got, want = _decoded(str(tmp_path / "rally1.mp4")), _decoded(str(tmp_path / "jax.mp4"))
    assert got.shape == (14, 2 * H, 2 * W, 3)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, read_rgb(clips[1]))  # the comets were drawn


def test_write_pred_video_with_labels_equals_jax(data, tmp_path):
    _, clips, _ = data
    rng = np.random.default_rng(4)
    n = 11
    pred = {"Frame": list(range(n)), "X": rng.integers(0, 2 * W, n).tolist(),
            "Y": rng.integers(0, 2 * H, n).tolist(), "Visibility": [1, 0] * 5 + [1]}
    label = {"Frame": list(range(n - 2)), "X": rng.integers(0, 2 * W, n - 2).tolist(),
             "Y": rng.integers(0, 2 * H, n - 2).tolist(), "Visibility": [1] * (n - 2)}
    write_pred_video(clips[0], pred, str(tmp_path / "port.mp4"), traj_len=3, label=label)
    jax_write_pred_video(clips[0], pred, str(tmp_path / "jax.mp4"), traj_len=3,
                         label_df=pd.DataFrame(label))
    np.testing.assert_array_equal(_decoded(str(tmp_path / "port.mp4")),
                                  _decoded(str(tmp_path / "jax.mp4")))
