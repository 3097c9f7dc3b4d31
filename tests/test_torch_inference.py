"""The port's single-video serving path vs the JAX package's on the CPU.

Both packages load the same checkpoints, written by the JAX package's
``save_checkpoint`` from a JAX random init, and run at float32 at the
sizes of ``tests/test_staged.py`` (32x64, seq_len 3, batch 4):

- ``run_staged`` over one staged buffer of T=18 (full chunks, a partial
  chunk, the flush) in ``weight``, ``average`` and ``nonoverlap``: equal
  rows. A frame may differ only where the JAX heatmap of that frame has a
  pixel within 1e-4 of the 0.5 threshold; such frames are counted.
- ``inpaint_trajectory``: equal rows in all three eval modes.
- ``predict_video`` and the predict CLI (``--device cpu``) on an mp4
  written by cv2 write the CSV of the JAX ``predict_video``, both decoding
  with cv2 (``native_decode=False``, ``--cv2_decode``; the JAX predictor at
  float32), byte for byte; so does
  ``predict_video(conv_backend="hand_k3c")`` / ``"hand_9tap"``, whose 3x3
  convs go through the plain version of ``ops/conv3x3.py`` on the CPU.
- Without a card the serving entry points raise unless the CPU is asked
  for; the JAX package's TPU options and flags raise
  ``NotImplementedError``, and the serving options the port took since
  (streaming, device resize, the overlay video, ``--video_dir``, the native
  decoder and the staging format, ``--profile``, ``--num_devices``) run on
  the CPU. Their parity with the JAX package is in
  ``tests/test_torch_serve_resident.py``, ``test_torch_streaming.py``,
  ``test_torch_batch_serving.py``, ``test_torch_predict_cli.py``,
  ``test_torch_native_*.py`` and ``test_torch_mesh_serving.py``.
"""

import functools
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import cv2  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tracknetv3_tpu.inference as jinf  # noqa: E402
from tracknetv3_tpu.models import get_model as jax_get_model  # noqa: E402
from tracknetv3_tpu.models.fused_forward import tracknet_fused_forward  # noqa: E402
from tracknetv3_tpu.ops.ensemble import ensemble_offline, get_ensemble_weight  # noqa: E402
from tracknetv3_tpu.ops.preprocess import make_staged_preprocessor  # noqa: E402
from tracknetv3_tpu.training.checkpoint import save_checkpoint  # noqa: E402
from tracknetv3_tpu_torch import inference as tinf  # noqa: E402
from tracknetv3_tpu_torch import predict as predict_cli  # noqa: E402

H, W, L, B, T = 32, 64, 3, 4, 18
NEAR = 1e-4  # |p - 0.5| under which a pixel may decode either way


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    _, tv = jax_get_model("TrackNet", L, "concat", rng=jax.random.PRNGKey(0))
    tv = jax.tree_util.tree_map(np.array, tv)
    # a random init puts every logit near 0.09 (std 0.07): scale and shift
    # the predictor so that a few percent of pixels pass 0.5, like a
    # trained model's sparse heatmaps
    tv["params"]["predictor"]["kernel"] *= 40.0
    tv["params"]["predictor"]["bias"][:] = -7.6
    tn = str(d / "TrackNet_best.pt")
    save_checkpoint(tn, epoch=0, max_val_acc=0.0, model=tv,
                    param_dict=dict(model_name="TrackNet", seq_len=L, bg_mode="concat"))
    _, iv = jax_get_model("InpaintNet", 16, rng=jax.random.PRNGKey(1))
    inp = str(d / "InpaintNet_best.pt")
    save_checkpoint(inp, epoch=0, max_val_acc=0.0, model=iv,
                    param_dict=dict(model_name="InpaintNet", seq_len=16))
    yield tn, inp
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each


def _predictors(ckpts, eval_mode, inpaint=False):
    tn, inp = ckpts
    kw = dict(eval_mode=eval_mode, batch_size=B, input_hw=(H, W))
    jp = jinf.TrackNetPredictor(tn, inp if inpaint else None, compute_dtype=jnp.float32,
                                native_decode=False, **kw)
    tp = tinf.TrackNetPredictor(tn, inp if inpaint else None, compute_dtype=torch.float32,
                                device="cpu", **kw)
    return jp, tp


def _buf(seed=3):
    return np.random.default_rng(seed).integers(0, 255, (T, H, W, 3), np.uint8)


def _jax_heatmaps(jp, staged):
    """The JAX package's per-frame heatmaps the rows were decoded from."""
    pre = make_staged_preprocessor(jp.bg_mode, L, staged.bgr)
    if jp.eval_mode == "nonoverlap":
        n_win = -(-T // L)
        x = pre(staged.buf, staged.median, jnp.arange(n_win) * L)
        probs = tracknet_fused_forward(jp._folded, x, dtype=jnp.float32)
        return np.asarray(jnp.moveaxis(probs, -1, 1)).reshape(-1, H, W)[:T]
    S = T - L + 1
    x = pre(staged.buf, staged.median, jnp.arange(S))
    probs = tracknet_fused_forward(jp._folded, x, dtype=jnp.float32)
    weights = jnp.asarray(get_ensemble_weight(L, jp.eval_mode))
    return np.asarray(ensemble_offline(jnp.moveaxis(probs, -1, 1), weights))[:T]


@pytest.mark.parametrize("bgr", [False, True])
@pytest.mark.parametrize("eval_mode", ["weight", "average", "nonoverlap"])
def test_run_staged_matches_jax(ckpts, eval_mode, bgr):
    jp, tp = _predictors(ckpts, eval_mode)
    buf = _buf()
    jbuf = jnp.asarray(buf)
    jstaged = jinf.StagedVideo(buf=jbuf, T=T, median=jp._median_staged(jbuf, None), bgr=bgr,
                               src_wh=(2 * W, 2 * H))
    want = jp.run_staged(jstaged)
    staged = tp.stage_frames(buf, bgr=bgr, src_wh=(2 * W, 2 * H))
    assert staged.T == T and staged.buf.dtype == torch.uint8
    np.testing.assert_array_equal(staged.median.numpy(), np.asarray(jstaged.median))
    got = tp.run_staged(staged)
    assert got["Frame"] == want["Frame"] == list(range(T))

    near = np.abs(_jax_heatmaps(jp, jstaged) - 0.5).min(axis=(1, 2)) < NEAR
    differ = [t for t in range(T)
              if (got["X"][t], got["Y"][t], got["Visibility"][t])
              != (want["X"][t], want["Y"][t], want["Visibility"][t])]
    assert all(near[t] for t in differ), (differ, np.flatnonzero(near))
    assert sum(want["Visibility"]) > 0  # the comparison sees real detections
    assert len(differ) <= int(near.sum())


def _trajectory(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 100, n)
    y = rng.integers(10, 60, n)
    vis = np.ones(n, int)
    vis[5:9] = vis[20:23] = 0  # two occlusion gaps inside the frame
    x[vis == 0] = y[vis == 0] = 0
    return {"Frame": list(range(n)), "X": x.tolist(), "Y": y.tolist(),
            "Visibility": vis.tolist()}


@pytest.mark.parametrize("eval_mode", ["weight", "average", "nonoverlap"])
def test_inpaint_trajectory_matches_jax(ckpts, eval_mode):
    jp, tp = _predictors(ckpts, eval_mode, inpaint=True)
    traj = _trajectory(45, 21)
    want = jp.inpaint_trajectory(traj, (128, 72))
    got = tp.inpaint_trajectory(traj, (128, 72))
    assert got == want
    assert got["Frame"] == list(range(45))
    assert got["X"][6] != 0  # the gap was inpainted


def _write_clip(path, n, seed):
    """A smooth mp4 at twice the model resolution with a moving bright square
    (the clip of ``tests/test_staged.py``)."""
    rng = np.random.default_rng(seed)
    base = np.zeros((2 * H, 2 * W, 3), np.uint8)
    base[:, :, 1] = np.linspace(30, 200, 2 * W, dtype=np.uint8)[None, :]
    base[:, :, 2] = rng.integers(0, 30, (2 * H, 2 * W), dtype=np.uint8)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (2 * W, 2 * H))
    for t in range(n):
        f = base.copy()
        y, x = 8 + (t % 10), 16 + 4 * (t % 20)
        f[y : y + 6, x : x + 6] = 255
        vw.write(f[..., ::-1])
    vw.release()


@pytest.fixture(scope="module")
def clip_and_want(ckpts, tmp_path_factory):
    """An mp4 and the CSV the JAX package's predict_video writes for it."""
    d = tmp_path_factory.mktemp("clip")
    clip = str(d / "clip.mp4")
    _write_clip(clip, 17, 5)
    tn, inp = ckpts
    jax_f32 = functools.partial(jinf.TrackNetPredictor, compute_dtype=jnp.float32)
    mp = pytest.MonkeyPatch()
    mp.setattr(jinf, "TrackNetPredictor", jax_f32)
    try:
        jinf.predict_video(clip, tn, inp, batch_size=B, input_hw=(H, W), native_decode=False,
                           bucket_quantum=16, save_dir=str(d / "jax"))
    finally:
        mp.undo()
    with open(d / "jax" / "clip_ball.csv") as f:
        want = f.read()
    assert len(want.splitlines()) == 18
    return clip, want


def test_predict_video_csv_matches_jax(ckpts, clip_and_want, tmp_path):
    clip, want = clip_and_want
    tn, inp = ckpts
    pred = tinf.predict_video(clip, tn, inp, batch_size=B, input_hw=(H, W), device="cpu",
                              compute_dtype=torch.float32, save_dir=str(tmp_path),
                              native_decode=False)
    with open(tmp_path / "clip_ball.csv") as f:
        assert f.read() == want
    assert len(pred["Frame"]) == 17


@pytest.mark.parametrize("backend", ["hand_k3c", "hand_9tap"])
def test_predict_video_hand_conv_backend_csv_matches_jax(ckpts, clip_and_want, tmp_path,
                                                         backend):
    clip, want = clip_and_want
    tn, inp = ckpts
    pred = tinf.predict_video(clip, tn, inp, batch_size=B, input_hw=(H, W), device="cpu",
                              compute_dtype=torch.float32, conv_backend=backend,
                              save_dir=str(tmp_path), native_decode=False)
    with open(tmp_path / "clip_ball.csv") as f:
        assert f.read() == want
    assert len(pred["Frame"]) == 17


def test_predict_cli_passes_conv_backend_on(ckpts, monkeypatch):
    seen = {}
    monkeypatch.setattr(tinf, "predict_video", lambda **kw: seen.update(kw))
    predict_cli.main(["--video_file", "v.mp4", "--tracknet_file", ckpts[0], "--device", "cpu",
                      "--conv_backend", "hand_9tap"])
    assert seen["conv_backend"] == "hand_9tap"
    predict_cli.main(["--video_file", "v.mp4", "--tracknet_file", ckpts[0], "--device", "cpu"])
    assert seen["conv_backend"] is None  # the predictor's rule picks it
    with pytest.raises(SystemExit):
        predict_cli.main(["--video_file", "v.mp4", "--tracknet_file", ckpts[0],
                          "--conv_backend", "winograd"])


def test_predict_cli_csv_matches_jax(ckpts, clip_and_want, tmp_path, monkeypatch):
    """``python -m tracknetv3_tpu_torch.predict --device cpu``: its main(),
    with the model resolution cut to the test size and the predictor made
    at float32, as the JAX reference's is."""
    clip, want = clip_and_want
    tn, inp = ckpts
    monkeypatch.setattr(tinf, "HEIGHT", H)
    monkeypatch.setattr(tinf, "WIDTH", W)
    asked = []
    real = tinf.TrackNetPredictor

    def predictor_f32(*args, compute_dtype=None, **kwargs):
        asked.append(compute_dtype)
        return real(*args, compute_dtype=torch.float32, **kwargs)

    monkeypatch.setattr(tinf, "TrackNetPredictor", predictor_f32)
    predict_cli.main(["--video_file", clip, "--tracknet_file", tn, "--inpaintnet_file", inp,
                      "--batch_size", str(B), "--save_dir", str(tmp_path), "--device", "cpu",
                      "--cv2_decode"])
    assert asked == [None]  # the CLI serves at the predictor's default, bfloat16
    with open(tmp_path / "clip_ball.csv") as f:
        assert f.read() == want


def test_serving_entry_points_need_a_card_or_an_explicit_cpu(ckpts, clip_and_want, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    tn, _ = ckpts
    clip, _ = clip_and_want
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.TrackNetPredictor(tn, input_hw=(H, W))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinf.predict_video(clip, tn, input_hw=(H, W))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_cli.main(["--video_file", clip, "--tracknet_file", tn,
                          "--save_dir", str(tmp_path)])


# options and flags of the JAX package that the port serves since streaming,
# device resize, the overlay video, batch serving, the native decoder,
# YUV420 staging and data-parallel serving came in
PORTED_OPTIONS = {"large_video", "device_resize", "output_video", "video_range",
                  "native_decode", "stage_format", "num_devices"}
PORTED_FLAGS = {"--video_dir", "--large_video", "--output_video", "--device_resize",
                "--traj_len", "--video_range", "--fail_fast", "--stage_format", "--profile",
                "--num_devices"}


def _served(save_dir, n_rows=17):
    """The CSV a served run wrote: its row count."""
    with open(os.path.join(save_dir, "clip_ball.csv")) as f:
        assert sum(1 for _ in f) - 1 == n_rows


@pytest.mark.parametrize("option", [
    dict(large_video=True), dict(device_resize=True), dict(output_video=True),
    dict(native_decode=True), dict(num_devices=2), dict(stage_format="yuv420"),
    dict(bucket_quantum=256), dict(program_cache_dir="x"), dict(video_range=(0, 1)),
])
def test_predict_video_unported_options_raise(ckpts, clip_and_want, option, tmp_path):
    """The JAX package's TPU options raise ``NotImplementedError``; those the
    port serves (``PORTED_OPTIONS``) run on the CPU and write the CSV (and
    the overlay video); the forced ``yuv420`` stages YUV420 rows through
    the native reader; ``num_devices=2`` serves on a 2-entry CPU mesh."""
    tn, _ = ckpts
    clip, _ = clip_and_want
    if set(option) <= PORTED_OPTIONS:
        seen, meshes = [], []
        real = tinf.TrackNetPredictor.upload_video
        real_run = tinf.TrackNetPredictor.run_staged

        def upload(p, *args, **kwargs):
            up = real(p, *args, **kwargs)
            seen.append((p.decode_backend, up.yuv))
            return up

        def run_staged(p, staged, img_scaler=None, mesh=None):
            meshes.append(None if mesh is None else [str(d) for d in mesh.devices])
            return real_run(p, staged, img_scaler, mesh)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tinf.TrackNetPredictor, "upload_video", upload)
            mp.setattr(tinf.TrackNetPredictor, "run_staged", run_staged)
            pred = tinf.predict_video(clip, tn, input_hw=(H, W), device="cpu", batch_size=B,
                                      save_dir=str(tmp_path), **option)
        assert pred["Frame"] == list(range(17))
        if option.get("stage_format") == "yuv420":
            assert seen == [("native-lowres1+yuv420", True)]
        if "num_devices" in option:
            assert meshes == [["cpu", "cpu"]]
        _served(tmp_path)
        assert os.path.exists(tmp_path / "clip.mp4") == ("output_video" in option)
        return
    with pytest.raises(NotImplementedError):
        tinf.predict_video(clip, tn, input_hw=(H, W), device="cpu", **option)


@pytest.mark.parametrize("flags", [
    ["--video_dir", "d"], ["--large_video"], ["--output_video"], ["--device_resize"],
    ["--num_devices", "2"], ["--stage_format", "bgr"], ["--bucket_quantum", "16"],
    ["--traj_len", "4"], ["--video_range", "0,1"], ["--profile", "p"], ["--fail_fast"],
])
def test_predict_cli_unported_flags_raise(ckpts, clip_and_want, flags, tmp_path, monkeypatch):
    """The JAX CLI's TPU flags raise ``NotImplementedError``; those the port
    serves (``PORTED_FLAGS``) run on the CPU (``--video_dir`` over the
    clip's directory; ``--profile`` into the test's directory, where the
    trace must be; ``--num_devices 2`` on a 2-entry CPU mesh) and write the
    CSV."""
    tn, _ = ckpts
    clip, _ = clip_and_want
    if flags[0] not in PORTED_FLAGS:
        with pytest.raises(NotImplementedError):
            predict_cli.main(["--video_file", "v.mp4", "--tracknet_file", tn,
                              "--device", "cpu"] + flags)
        return
    monkeypatch.setattr(tinf, "HEIGHT", H)
    monkeypatch.setattr(tinf, "WIDTH", W)
    source = ["--video_file", clip]
    if flags[0] == "--video_dir":
        source, flags = ["--video_dir", os.path.dirname(clip)], []
    if flags[:1] == ["--profile"]:
        flags = ["--profile", str(tmp_path / "profile")]
    predict_cli.main(source + ["--tracknet_file", tn, "--device", "cpu", "--batch_size", str(B),
                               "--save_dir", str(tmp_path)] + flags)
    _served(tmp_path)
    if flags[:1] == ["--profile"]:
        assert os.path.getsize(tmp_path / "profile" / "trace.json") > 0


def test_stage_frames_checks_its_input(ckpts):
    _, tp = _predictors(ckpts, "weight")
    with pytest.raises(ValueError, match="uint8"):
        tp.stage_frames(np.zeros((4, H + 1, W, 3), np.uint8))
    with pytest.raises(ValueError, match="zero frames"):
        tp.stage_frames(np.zeros((0, H, W, 3), np.uint8))


def test_video_reader_needs_cv2(monkeypatch, tmp_path):
    import builtins

    from tracknetv3_tpu_torch.utils.io import VideoReader

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="needs OpenCV"):
        VideoReader(str(tmp_path / "v.mp4"))


def test_write_pred_csv_matches_jax(tmp_path):
    from tracknetv3_tpu.utils.io import write_pred_csv as jax_write
    from tracknetv3_tpu_torch.utils.io import write_pred_csv

    pred = {"Frame": [0, 1, 2], "Visibility": [1, 0, 1], "X": [10, 0, 512], "Y": [3, 0, 288]}
    jax_write(pred, str(tmp_path / "a.csv"))
    write_pred_csv(pred, str(tmp_path / "b.csv"))
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()
    full = dict(pred, Visibility_GT=[1, 1, 0], X_GT=[9, 5, 0], Y_GT=[2, 4, 0],
                Inpaint_Mask=[0, 1, 0])
    jax_write(full, str(tmp_path / "c.csv"), save_inpaint_mask=True)
    write_pred_csv(full, str(tmp_path / "d.csv"), save_inpaint_mask=True)
    assert (tmp_path / "c.csv").read_bytes() == (tmp_path / "d.csv").read_bytes()
    assert os.path.getsize(tmp_path / "d.csv") > 0
