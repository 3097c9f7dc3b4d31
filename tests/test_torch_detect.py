"""The port's ``decode_heatmaps`` vs the JAX package's: bit-exact on cx, cy,
vis and bbox, and on conf (atol 0), over single blobs, several blobs,
empty and sub-threshold maps, blobs at the frame edges, blobs larger than
the 64-px crop, and flat plateaus (argmax ties)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.ops.detect import decode_heatmaps as jax_decode  # noqa: E402
from tracknetv3_tpu_torch.ops.detect import decode_heatmaps  # noqa: E402

H, W = 72, 136  # larger than the crop in both directions


def _blob(m, cx, cy, r, peak):
    yy, xx = np.mgrid[0:H, 0:W]
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    m[...] = np.maximum(m, np.where(d2 <= r * r, peak * np.exp(-d2 / (2.0 * r * r)), 0.0))


def _maps():
    rng = np.random.default_rng(0)
    cases = {}
    m = np.zeros((H, W), np.float32)
    _blob(m, 40, 30, 3, 0.95)
    cases["single"] = m
    m = np.zeros((H, W), np.float32)
    _blob(m, 20, 20, 4, 0.7)
    _blob(m, 100, 50, 2, 0.9)
    _blob(m, 60, 10, 6, 0.8)
    cases["multi"] = m
    cases["empty"] = np.zeros((H, W), np.float32)
    m = np.zeros((H, W), np.float32)
    _blob(m, 50, 40, 5, 0.45)
    cases["sub_threshold"] = m
    for name, (cx, cy) in {"corner_tl": (0, 0), "corner_br": (W - 1, H - 1),
                           "edge_top": (70, 0), "edge_right": (W - 1, 33)}.items():
        m = np.zeros((H, W), np.float32)
        _blob(m, cx, cy, 4, 0.99)
        cases[name] = m
    m = np.zeros((H, W), np.float32)
    m[2:70, 10:100] = 0.6 + 0.3 * rng.random((68, 90))  # 68 x 90 > 64 x 64 crop
    cases["larger_than_crop"] = m
    m = np.zeros((H, W), np.float32)
    m[30:36, 50:60] = 0.8  # plateau: argmax takes the first index
    m[10:12, 5:9] = 0.8
    cases["plateau_ties"] = m
    m = (rng.random((H, W)) * 0.4).astype(np.float32)
    _blob(m, 90, 20, 3, 0.97)
    cases["noise_and_blob"] = m
    cases["noise_above"] = (0.45 + 0.1 * rng.random((H, W))).astype(np.float32)
    return cases


def _check(probs):
    want = {k: np.asarray(v) for k, v in jax_decode(jnp.asarray(probs)).items()}
    got = {k: v.numpy() for k, v in decode_heatmaps(torch.from_numpy(probs)).items()}
    assert set(got) == set(want)
    for k in ("cx", "cy", "vis", "bbox"):
        assert got[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["conf"], want["conf"])
    return got


@pytest.mark.parametrize("case", sorted(_maps()))
def test_decode_matches_jax_bit_exact(case):
    got = _check(_maps()[case][None])
    if case in ("empty", "sub_threshold"):
        assert int(got["vis"][0]) == 0 and float(got["conf"][0]) == 0.0


def test_batched_leading_shape_matches_jax():
    maps = _maps()
    probs = np.stack([maps[k] for k in sorted(maps)]).reshape(2, -1, H, W)
    got = _check(probs)
    assert got["cx"].shape == probs.shape[:2] and got["bbox"].shape == probs.shape[:2] + (4,)


def test_small_maps_shrink_the_crop():
    m = np.zeros((2, 3, 16, 24), np.float32)
    m[0, 1, 3:6, 20:24] = 0.9
    m[1, 2, 10:16, 0:3] = 0.7
    _check(m)
