"""The port's exact largest-bbox-area decode and its host oracle vs the JAX
package's, on the CPU.

- ``decode_heatmaps_exact`` against the JAX ``decode_heatmaps_exact`` (the
  device rule) and the JAX ``decode_heatmaps_host`` (scipy) on a seeded
  multi-blob corpus with area ties, blobs larger than the crop and empty
  maps, at leading shapes ``S + (H, W)``: integer fields bit-exact, ``conf``
  equal. The result does not depend on ``crop``; two deliberately wrong
  rules (area ties kept last in raster order, a fill capped at the crop)
  must disagree with the oracle on the same corpus.
- ``torch.argmax`` returns the first maximum, which the seed rule relies on.
- The port's ``decode_heatmaps_host`` against the JAX package's, on the
  native library and on scipy; the port's loader says on stderr which runs,
  and falls back to scipy where the library does not build.
- ``utils.io.png_size`` against PIL's ``Image.open(path).size``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from tracknetv3_tpu.ops.detect import decode_heatmaps_exact as jax_exact  # noqa: E402
from tracknetv3_tpu.ops.detect import decode_heatmaps_host as jax_host  # noqa: E402
from tracknetv3_tpu_torch.ops import detect  # noqa: E402
from tracknetv3_tpu_torch.utils.io import png_size  # noqa: E402

INT_FIELDS = ("cx", "cy", "vis", "bbox")


def _corpus(seed: int, n: int = 24, h: int = 48, w: int = 80) -> np.ndarray:
    """Seeded multi-blob maps: random rectangles and disks of random levels
    above 0.5 (some overlapping), two blobs of equal bounding-box area in
    every fourth map (the later one in raster order brighter), a blob wider
    than a 16-pixel crop in every fifth, and an empty map in every seventh."""
    rng = np.random.default_rng(seed)
    maps = rng.uniform(0.0, 0.5, (n, h, w)).astype(np.float32)  # sub-threshold noise
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        if i % 7 == 3:
            continue
        for _ in range(int(rng.integers(1, 6))):
            v = np.float32(rng.uniform(0.55, 1.0))
            if rng.random() < 0.5:
                y0, x0 = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 8))
                maps[i, y0 : y0 + int(rng.integers(1, 8)), x0 : x0 + int(rng.integers(1, 8))] = v
            else:
                cy, cx = int(rng.integers(2, h - 2)), int(rng.integers(2, w - 2))
                maps[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= int(rng.integers(1, 12))] = v
        if i % 4 == 0:  # an area tie, the raster-later blob brighter
            maps[i, 1:4, 1:5] = 0.6
            maps[i, h - 5 : h - 2, w - 6 : w - 2] = 0.97
        if i % 5 == 0:  # wider than the crop, dimmer than the rest
            maps[i, 20:30, 4 : w - 4] = 0.56
    maps[n // 2, :, :] = 0.2  # an empty map
    return maps


def _assert_same(got, want, what: str):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what}: {k}")
    np.testing.assert_array_equal(np.asarray(got["conf"]), np.asarray(want["conf"]),
                                  err_msg=f"{what}: conf")


@pytest.mark.parametrize("lead", [(24,), (4, 6), (2, 3, 4)])
def test_exact_matches_jax_rule_and_host_oracle(lead):
    maps = _corpus(seed=len(lead))
    x = maps.reshape(lead + maps.shape[1:])
    got = detect.decode_heatmaps_exact(torch.from_numpy(x), crop=16)
    assert got["cx"].shape == lead and got["bbox"].shape == lead + (4,)
    assert got["cx"].dtype == torch.int32 and got["conf"].dtype == torch.float32
    got = {k: v.numpy() for k, v in got.items()}
    _assert_same(got, jax_exact(jnp.asarray(x), crop=16), "JAX device rule")
    _assert_same(got, jax_host(x, use_native=False), "JAX host oracle (scipy)")
    # the comparison sees the maps where the rule matters
    peak = detect.decode_heatmaps(torch.from_numpy(x))
    assert (peak["cx"].numpy() != got["cx"]).sum() >= 3
    assert (got["vis"] == 0).sum() >= 1


@pytest.mark.parametrize("crop", [4, 16, 96])
def test_exact_does_not_depend_on_crop(crop):
    maps = _corpus(seed=11, n=10)
    got = detect.decode_heatmaps_exact(torch.from_numpy(maps), crop=crop)
    _assert_same({k: v.numpy() for k, v in got.items()}, jax_host(maps, use_native=False),
                 f"crop {crop}")


def test_area_tie_goes_to_the_raster_first_blob():
    m = np.zeros((48, 48), np.float32)
    m[5:9, 5:9] = 0.6  # first in raster order, dimmer
    m[30:34, 30:34] = 0.95  # the same 4x4 box, brighter: extracted first
    got = detect.decode_heatmaps_exact(torch.from_numpy(m))
    assert (int(got["cx"]), int(got["cy"])) == (7, 7)
    assert got["bbox"].tolist() == [5, 5, 4, 4]
    assert float(got["conf"]) == np.float32(0.6)


def test_giant_blob_exceeds_the_crop():
    m = np.zeros((96, 160), np.float32)
    m[8:88, 10:150] = 0.7  # 140x80, far larger than the 16-pixel crop
    m[2:4, 2:4] = 0.99  # brighter but tiny
    got = detect.decode_heatmaps_exact(torch.from_numpy(m), crop=16)
    want = jax_exact(jnp.asarray(m), crop=16)
    _assert_same({k: v.numpy() for k, v in got.items()}, want, "giant blob")
    assert got["bbox"].tolist() == [10, 8, 140, 80]


def test_empty_frames_beside_busy_ones_decode_to_zeros():
    """Frames that run out of blobs early keep their result while the others
    go on; a frame with nothing above the threshold stays zeros, and a blob
    at the origin decodes invisible."""
    maps = np.zeros((3, 32, 48), np.float32)
    maps[1, 2:5, 2:5] = maps[1, 10:12, 30:40] = maps[1, 20:30, 5:7] = 0.8  # three blobs
    maps[2, 0, 0] = 1.0
    got = detect.decode_heatmaps_exact(torch.from_numpy(maps))
    assert got["cx"].tolist() == [0, 35, 0] and got["cy"].tolist() == [0, 11, 0]
    assert got["vis"].tolist() == [0, 1, 0]
    assert got["bbox"][0].tolist() == [0, 0, 0, 0] and float(got["conf"][0]) == 0.0
    _assert_same({k: v.numpy() for k, v in got.items()}, jax_host(maps, use_native=False),
                 "mixed batch")


def test_argmax_takes_the_first_maximum():
    """The seed is the first brightest unclaimed pixel in raster order, as
    JAX's argmax: torch.argmax must return the first of equal maxima."""
    m = torch.zeros(6, 7)
    m[1, 5] = m[4, 2] = m[4, 6] = 0.9
    assert int(m.flatten().argmax()) == 1 * 7 + 5
    rows = torch.tensor([[0.3, 0.9, 0.9, 0.1], [0.9, 0.9, 0.9, 0.9]])
    assert rows.argmax(dim=1).tolist() == [1, 0]
    # two equal peaks: the first seeds, and the blobs tie on area
    maps = np.zeros((1, 20, 20), np.float32)
    maps[0, 12:14, 3:5] = maps[0, 2:4, 15:17] = 0.9
    got = detect.decode_heatmaps_exact(torch.from_numpy(maps))
    assert got["bbox"][0].tolist() == [15, 2, 2, 2]


@pytest.mark.parametrize("wrong", ["ties_kept_last", "fill_capped_at_crop"])
def test_wrong_rules_fail_the_oracle(wrong, monkeypatch):
    """The corpus tells the rule apart from two near misses: area ties to the
    raster-later blob, and a crop-local fill that is never expanded."""
    if wrong == "ties_kept_last":
        monkeypatch.setattr(detect, "_better", lambda area, first, best_area, best_first:
                            (area > best_area) | ((area == best_area) & (first > best_first)))
    else:
        monkeypatch.setattr(detect, "_expand", lambda region, remaining, active: region)
    maps = _corpus(seed=1)
    got = detect.decode_heatmaps_exact(torch.from_numpy(maps), crop=16)
    want = jax_host(maps, use_native=False)
    assert not np.array_equal(got["bbox"].numpy(), want["bbox"])


@pytest.mark.parametrize("use_native", [True, False])
def test_host_decode_matches_jax(use_native):
    from tracknetv3_tpu_torch import native_ccl

    maps = _corpus(seed=5).reshape(4, 6, 48, 80)
    got = detect.decode_heatmaps_host(maps, use_native=use_native)
    want = jax_host(maps, use_native=use_native)
    assert got["cx"].shape == (4, 6)
    _assert_same(got, want, f"use_native={use_native}")
    backend = detect.host_backend(use_native)
    assert backend == ("native" if use_native and native_ccl.available() else "scipy")


def test_native_loader_says_what_runs(monkeypatch, capfd):
    from tracknetv3_tpu_torch import native_ccl

    monkeypatch.setattr(native_ccl, "_lib", None)  # load again
    assert native_ccl.available()
    assert "native_ccl: decode_heatmaps_host runs" in capfd.readouterr().err
    monkeypatch.setattr(native_ccl, "_lib", None)
    monkeypatch.setattr(native_ccl, "_build_failed", False)  # restored after the test
    monkeypatch.setattr(native_ccl, "_LIB_PATH", "/nonexistent/libtrackdecode.so")
    monkeypatch.setattr(native_ccl, "_NATIVE_DIR", "/nonexistent")
    assert native_ccl.decode_heatmaps_native(np.zeros((2, 4, 4), np.float32)) is None
    assert "runs scipy.ndimage" in capfd.readouterr().err
    assert detect.host_backend() == "scipy"
    got = detect.decode_heatmaps_host(_corpus(seed=2, n=4))
    _assert_same(got, jax_host(_corpus(seed=2, n=4), use_native=False), "scipy fallback")


@pytest.mark.parametrize("size,mode", [((64, 32), "RGB"), ((1280, 720), "L"),
                                       ((3, 5), "RGBA"), ((512, 288), "P")])
def test_png_size_matches_pil(tmp_path, size, mode):
    path = str(tmp_path / "0.png")
    Image.new(mode, size).save(path)
    with Image.open(path) as im:
        assert png_size(path) == im.size == size


def test_png_size_refuses_other_files(tmp_path):
    path = str(tmp_path / "0.png")
    Image.new("RGB", (8, 8)).save(path, format="JPEG")
    with pytest.raises(ValueError, match="not a PNG"):
        png_size(path)
