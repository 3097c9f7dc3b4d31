"""The port's native libav reader and YUV420 conversion against the JAX
package's, on the CPU:

- ``ops.preprocess.yuv420_to_rgb`` bit-equal to the JAX function on seeded
  planes over the whole 0..255 range (``y < 16``, where ``c`` is negative
  and the arithmetic shift rounds down, and the clip at both ends occur),
  in one slab and in slabs that split the frames;
- ``NativeVideoReader`` against the JAX reader on an mpeg4 and an h264 clip
  that ``write_test_clip`` encodes: ``read_into`` (BGR and RGB),
  ``read_into_yuv`` and ``read_batch`` byte for byte, the same
  ``applied_lowres`` at ``lowres=0`` and ``-1``, the same source size,
  frame count and rate; ``probe_video`` the same;
- the build (``native_build``): the library lands in ``build/`` under a
  hashed name, processes that build it at once all load a whole file, and
  nothing is written into ``native/``; a source that does not build makes
  ``open_native_video`` return None and says so on stderr.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu import native_video as jnv  # noqa: E402
from tracknetv3_tpu.ops.preprocess import yuv420_to_rgb as jax_yuv420_to_rgb  # noqa: E402
from tracknetv3_tpu_torch import native_build, native_video  # noqa: E402
from tracknetv3_tpu_torch.ops.preprocess import yuv420_to_rgb  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_W, OUT_H = 64, 32  # the model resolution of the serving tests
N = 24


def _planes(T, h, w, seed):
    """Seeded YUV420 rows spanning 0..255, with a frame of dark luma
    (y < 16) under saturated chroma in each half."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 256, (T, h * w * 3 // 2), dtype=np.uint8)
    flat[0, : h * w] = rng.integers(0, 16, h * w, dtype=np.uint8)
    flat[0, h * w:] = np.where(rng.random(h * w // 2) < 0.5, 0, 255).astype(np.uint8)
    return flat


@pytest.mark.parametrize("T,h,w,slab", [(6, 32, 64, 120), (7, 32, 64, 3), (5, 18, 30, 1),
                                        (3, 2, 2, 2)])
def test_yuv420_to_rgb_is_bit_equal_to_jax(T, h, w, slab):
    flat = _planes(T, h, w, seed=T * h + w)
    want = np.asarray(jax_yuv420_to_rgb(jnp.asarray(flat), h, w))
    got = yuv420_to_rgb(torch.from_numpy(flat), h, w, slab_frames=slab)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (T, h, w, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    y = flat[:, : h * w].astype(np.int64)
    assert (y < 16).any()  # c = 298 * (y - 16) + 128 < 0 occurs
    assert (want == 0).any() and (want == 255).any()  # both clips occur


def test_yuv420_to_rgb_writes_into_a_given_buffer_and_checks_its_input():
    flat = _planes(4, 8, 12, seed=1)
    out = torch.full((4, 8, 12, 3), 7, dtype=torch.uint8)
    assert yuv420_to_rgb(torch.from_numpy(flat), 8, 12, out=out, slab_frames=3) is out
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_yuv420_to_rgb(
        jnp.asarray(flat), 8, 12)))
    with pytest.raises(ValueError, match="YUV420 rows"):
        yuv420_to_rgb(torch.from_numpy(flat[:, :-1]), 8, 12)
    with pytest.raises(ValueError, match="YUV420 rows"):
        yuv420_to_rgb(torch.from_numpy(flat).to(torch.int32), 8, 12)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """An mpeg4 and an h264 clip at 320x180 from the library's encoder."""
    d = tmp_path_factory.mktemp("native")
    out = {}
    for codec in ("mpeg4", "libx264"):
        path = str(d / f"{codec}.mp4")
        assert native_video.write_test_clip(path, codec, n=N, w=320, h=180), codec
        out[codec] = path
    return out


def _read_all(reader, kind):
    if kind == "yuv":
        buf = np.empty((N, OUT_H * OUT_W * 3 // 2), np.uint8)
        return buf[: reader.read_into_yuv(buf)]
    if kind == "batch":
        parts = []
        while (b := reader.read_batch(5)) is not None:
            parts.append(b)
        return np.concatenate(parts)
    buf = np.empty((N, OUT_H, OUT_W, 3), np.uint8)
    return buf[: reader.read_into(buf)]


@pytest.mark.parametrize("kind", ["bgr", "rgb", "yuv", "batch"])
@pytest.mark.parametrize("lowres", [0, -1])
@pytest.mark.parametrize("codec", ["mpeg4", "libx264"])
def test_reader_matches_jax_reader(clips, codec, lowres, kind):
    bgr = kind != "rgb"
    got_r = native_video.open_native_video(clips[codec], OUT_W, OUT_H, lowres=lowres, bgr=bgr)
    want_r = jnv.open_native_video(clips[codec], OUT_W, OUT_H, lowres=lowres, bgr=bgr)
    assert got_r is not None and want_r is not None
    try:
        for k in ("src_w", "src_h", "n_frames", "fps", "applied_lowres"):
            assert getattr(got_r, k) == getattr(want_r, k), k
        assert (got_r.src_w, got_r.src_h) == (320, 180)  # full size under lowres
        if lowres == -1:  # mpeg4 decodes at a quarter, h264 has no lowres
            assert got_r.applied_lowres == (2 if codec == "mpeg4" else 0)
        got, want = _read_all(got_r, kind), _read_all(want_r, kind)
    finally:
        got_r.close()
        want_r.close()
    assert len(got) >= N - 1  # the encoder may hold back its last frame
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0


def test_probe_video_matches_jax(clips):
    for path in clips.values():
        assert native_video.probe_video(path) == jnv.probe_video(path)
    assert native_video.open_native_video(os.path.join(ROOT, "missing.mp4"), 64, 32) is None


def test_library_builds_into_build_not_native():
    path = native_build.build(native_video.SOURCE, native_video.LIBS)
    assert path.parent == native_build.BUILD_DIR
    assert path == native_build.library_path(native_video.SOURCE, native_video.LIBS)
    assert path.name.startswith("video_decode_") and path.suffix == ".so"
    # the flags are part of the name: the same source with other libraries is
    # another file
    assert native_build.library_path(native_video.SOURCE) != path


_BUILD_AND_LOAD = """
import ctypes, sys
from pathlib import Path
from tracknetv3_tpu_torch import native_build
native_build.BUILD_DIR = Path(sys.argv[1])
ctypes.CDLL(str(native_build.build("ccl_decode.cpp")))
print("loaded")
"""


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Four processes build the same library into an empty directory at
    once (each through its own temporary file and a rename): each loads
    it, one file is left, and ``native/`` gains nothing."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(tmp_path)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert all(o.strip() == "loaded" for o, _ in outs)
    assert [p.name for p in tmp_path.iterdir()] == [
        native_build.library_path("ccl_decode.cpp").name]
    # the JAX package's make may build its own libraries there meanwhile
    assert not [n for n in os.listdir(os.path.join(ROOT, "native"))
                if n.startswith("ccl_decode_")]


def test_missing_library_gives_no_reader(clips, monkeypatch, capfd):
    monkeypatch.setattr(native_video, "_lib", None)
    monkeypatch.setattr(native_video, "_build_failed", False)
    monkeypatch.setattr(native_video, "SOURCE", "missing_video_decode.cpp")  # nothing to build
    assert native_video.open_native_video(clips["mpeg4"], OUT_W, OUT_H) is None
    assert "videos decode with cv2" in capfd.readouterr().err
    assert not native_video.write_test_clip(str(clips["mpeg4"]) + ".again.mp4", "mpeg4")
    assert native_video.probe_video(clips["mpeg4"]) is None
    with pytest.raises(RuntimeError, match="unavailable"):
        native_video.NativeVideoReader(clips["mpeg4"], OUT_W, OUT_H)


def test_reader_refuses_a_buffer_it_would_overrun(clips):
    r = native_video.open_native_video(clips["mpeg4"], OUT_W, OUT_H)
    try:
        with pytest.raises(ValueError, match="C-contiguous writable"):
            r.read_into(np.empty((2, OUT_H, OUT_W - 2, 3), np.uint8))
        with pytest.raises(ValueError, match="C-contiguous writable"):
            r.read_into(np.empty((2, OUT_H, OUT_W, 3, 2), np.uint8)[..., 0])
        with pytest.raises(ValueError, match="C-contiguous writable"):
            r.read_into_yuv(np.empty((2, OUT_H * OUT_W), np.uint8))
        assert r.read_into(np.empty((2, OUT_H, OUT_W, 3), np.uint8)) == 2  # nothing consumed
    finally:
        r.close()
