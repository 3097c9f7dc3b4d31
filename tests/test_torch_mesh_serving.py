"""The port's data-parallel serving on the CPU against the JAX package's
(``tests/test_staged.py``'s sharded cases; both at float32, cv2 decode;
``tests/torch_serving_data.py``):

- ``run_staged(mesh=)`` in ``concat`` / ``weight`` and ``subtract`` /
  ``nonoverlap`` on 2- and 8-entry CPU meshes at batch 8: the rows of the
  port's ``mesh=None`` and of the JAX ``run_staged(mesh=make_mesh(8))`` on
  the same frames;
- ``predict_video`` and ``predict_videos`` with ``num_devices=2,
  device="cpu"`` write the CSVs of the JAX entry points with
  ``num_devices=2``, byte for byte;
- ``num_devices > 1`` refuses ``large_video`` and ``device_resize`` with the
  JAX ``ValueError``; a video over the staging budget streams on one device
  with the JAX warning; a batch the mesh does not divide, a mesh whose
  first device is not the predictor's and what is not a mesh are refused.
"""

import os
import shutil

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax.numpy as jnp  # noqa: E402

import tracknetv3_tpu.inference as jinf  # noqa: E402
from tests.torch_serving_data import (  # noqa: E402
    H, JAX_F32, PORT_ARGS, W, csv_text, detecting_checkpoint, inpaint_checkpoint, jax_predictor,
    port_predictor, read_rgb, visible, write_clip,
)
from tracknetv3_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from tracknetv3_tpu_torch import inference as tinf  # noqa: E402
from tracknetv3_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

MB = 8  # the batch of the sharded runs: divisible by the 8 JAX devices


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_serving")
    clips = {T: write_clip(str(d / f"clip{T}.mp4"), T, seed=60 + T) for T in (13, 29)}
    tns = {bg: detecting_checkpoint(str(d / f"tn_{bg}.pt"), bg, clips[29])
           for bg in ("concat", "subtract")}
    yield clips, tns, inpaint_checkpoint(str(d / "inp.pt"))
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each


def _frames(clip: str) -> np.ndarray:
    """The clip's RGB frames at the model resolution (cv2 INTER_LINEAR)."""
    return np.stack([cv2.resize(f, (W, H), interpolation=cv2.INTER_LINEAR)
                     for f in read_rgb(clip)])


@pytest.fixture(scope="module")
def jax_rows(data):
    """The JAX run_staged on its 8-device mesh, per (bg_mode, eval_mode)."""
    clips, tns, _ = data
    frames = _frames(clips[29])
    out = {}
    for bg, mode in (("concat", "weight"), ("subtract", "nonoverlap")):
        jp = jax_predictor(tns[bg], eval_mode=mode, batch_size=MB)
        staged = jp.finalize_staged([jnp.asarray(frames)], bgr=False, src_wh=(W, H))
        out[bg, mode] = jp.run_staged(staged, img_scaler=(1.0, 1.0), mesh=jax_make_mesh(8))
    return frames, out


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("bg,mode", [("concat", "weight"), ("subtract", "nonoverlap")])
def test_run_staged_sharded_matches_single_and_jax(data, jax_rows, bg, mode, n):
    _, tns, _ = data
    frames, want = jax_rows
    p = port_predictor(tns[bg], eval_mode=mode, batch_size=MB)
    staged = p.stage_frames(frames)
    single = p.run_staged(staged, img_scaler=(1.0, 1.0))
    got = p.run_staged(staged, img_scaler=(1.0, 1.0), mesh=make_mesh(n, device="cpu"))
    assert got == single == want[bg, mode]
    assert got["Frame"] == list(range(29)) and visible(got) > 0


def test_predict_video_num_devices_writes_the_jax_csv(data, tmp_path, monkeypatch):
    clips, tns, inp = data
    clip = clips[29]
    monkeypatch.setattr(jinf, "TrackNetPredictor", JAX_F32)
    jinf.predict_video(clip, tns["concat"], inp, batch_size=MB, input_hw=(H, W),
                       native_decode=False, num_devices=2, save_dir=str(tmp_path / "jax"))
    args = {**PORT_ARGS, "batch_size": MB}
    tinf.predict_video(clip, tns["concat"], inp, num_devices=2, save_dir=str(tmp_path / "two"),
                       **args)
    tinf.predict_video(clip, tns["concat"], inp, save_dir=str(tmp_path / "one"), **args)
    want = csv_text(tmp_path / "jax" / "clip29_ball.csv")
    assert csv_text(tmp_path / "two" / "clip29_ball.csv") == want
    assert csv_text(tmp_path / "one" / "clip29_ball.csv") == want


def test_predict_videos_num_devices_writes_the_jax_csvs(data, tmp_path):
    clips, tns, _ = data
    files = [clips[13], clips[29]]
    jinf.predict_videos(files, "", predictor=jax_predictor(tns["concat"], batch_size=MB),
                        num_devices=2, save_dir=str(tmp_path / "jax"))
    p = port_predictor(tns["concat"], batch_size=MB)
    got = tinf.predict_videos(files, "", predictor=p, num_devices=2,
                              save_dir=str(tmp_path / "two"))
    assert got == tinf.predict_videos(files, "", predictor=p)
    for name in ("clip13_ball.csv", "clip29_ball.csv"):
        assert csv_text(tmp_path / "two" / name) == csv_text(tmp_path / "jax" / name)
    assert sum(visible(v) for v in got.values()) > 0


@pytest.mark.parametrize("option", ["large_video", "device_resize"])
def test_num_devices_refuses_the_other_paths(data, option):
    clips, tns, _ = data
    for fn, kw in ((jinf.predict_video, {}), (tinf.predict_video, {"device": "cpu"})):
        with pytest.raises(ValueError, match="only supported on the default staged path"):
            fn(clips[13], tns["concat"], num_devices=2, **{option: True}, **kw)


def test_a_video_over_the_budget_streams_on_one_device(data, tmp_path, monkeypatch, capsys):
    clips, tns, _ = data
    clip = clips[13]
    seen = []
    real = tinf.TrackNetPredictor.predict_video_streaming

    def streaming(p, *args, **kwargs):
        seen.append(os.path.basename(args[0]))
        return real(p, *args, **kwargs)

    monkeypatch.setattr(tinf.TrackNetPredictor, "predict_video_streaming", streaming)
    want = tinf.predict_video(clip, tns["concat"], large_video=True, **PORT_ARGS)
    monkeypatch.setattr(tinf, "STAGING_BUDGET_BYTES", 1)
    got = tinf.predict_video(clip, tns["concat"], num_devices=2, **PORT_ARGS)
    assert got == want and seen == ["clip13.mp4", "clip13.mp4"]
    assert ("warning: video exceeds the staging budget; falling back to single-device "
            "streaming (num_devices ignored)") in capsys.readouterr().err
    stats = {}
    out = tinf.predict_videos([clip], tns["concat"], staging_budget_bytes=1, num_devices=2,
                              stats=stats, **PORT_ARGS)
    assert out[clip] == want and stats["streaming"] == [clip]
    assert ("warning: 1 video(s) exceed the staging budget and fall back to single-device "
            "streaming (num_devices ignored for them)") in capsys.readouterr().err


def test_meshes_that_cannot_shard_are_refused(data):
    clips, tns, _ = data
    p = port_predictor(tns["concat"], batch_size=4)
    staged = p.stage_frames(_frames(clips[13]))
    with pytest.raises(ValueError, match="batch_size 4 not divisible by mesh size 3"):
        p.run_staged(staged, mesh=make_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="first device cuda:0 is not the predictor's cpu"):
        p.run_staged(staged, mesh=make_mesh(devices=["cuda:0", "cuda:0"]))
    with pytest.raises(TypeError, match="Mesh"):
        p.run_staged(staged, mesh=object())
