"""The port's device resize (``ops/preprocess.py``) against the JAX
package's on the CPU:

- ``_pil_bicubic_matrix``: bit-equal, down- and up-scaling, the 720p ->
  288x512 sizes among them;
- ``resize_frames``: within 1e-4 of JAX's (float32, values up to 255),
  down- and up-scaling, one and three channels, with and without leading
  axes; the result clipped to [0, 255];
- ``make_window_preprocessor``: within 1e-5 of JAX's in all four
  ``bg_mode``s (the difference at source resolution for the subtract
  modes, the median resized for ``concat``);
- the matrix products run with TF32 off (``tf32_off`` also covers cuBLAS)
  and the flag gets its value back.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.ops import preprocess as jpre  # noqa: E402
from tracknetv3_tpu_torch.device import tf32_off  # noqa: E402
from tracknetv3_tpu_torch.ops import preprocess as tpre  # noqa: E402


@pytest.mark.parametrize("n_in,n_out", [(720, 288), (1280, 512), (64, 32), (128, 64),
                                        (16, 32), (37, 50), (50, 37), (32, 32)])
def test_pil_bicubic_matrix_is_bit_equal(n_in, n_out):
    want = jpre._pil_bicubic_matrix(n_in, n_out)
    got = tpre._pil_bicubic_matrix(n_in, n_out)
    assert got.dtype == np.float32 and got.shape == (n_out, n_in)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,hw", [
    ((4, 64, 128, 3), (32, 64)),  # down, three channels
    ((3, 16, 24, 1), (32, 64)),  # up, one channel
    ((2, 3, 45, 70, 3), (32, 64)),  # leading axes, odd sizes
    ((72, 128, 3), (32, 64)),  # one frame
    ((2, 30, 40, 1), (32, 20)),  # up in one axis, down in the other
])
def test_resize_frames_matches_jax(shape, hw):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(0, 256, shape).astype(np.uint8)
    x[..., :3, :3, :] = 255  # edges against 0: the bicubic overshoots, the clip holds it
    x[..., 3:6, :3, :] = 0
    want = np.asarray(jpre.resize_frames(jnp.asarray(x), *hw))
    got = tpre.resize_frames(torch.from_numpy(x), *hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:-3] + hw + shape[-1:]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 255.0


@pytest.mark.parametrize("bg_mode", ["", "subtract", "subtract_concat", "concat"])
def test_make_window_preprocessor_matches_jax(bg_mode):
    rng = np.random.default_rng(11)
    L, hw = 3, (32, 64)
    frames = rng.integers(0, 256, (9, 48, 80, 3)).astype(np.uint8)
    median = np.median(frames.astype(np.float32), axis=0)
    starts = np.array([0, 2, 5, 7], np.int32)  # the last window runs past the end
    want = np.asarray(jpre.make_window_preprocessor(bg_mode, L, hw=hw)(
        jnp.asarray(frames), jnp.asarray(median), jnp.asarray(starts)))
    got = tpre.make_window_preprocessor(bg_mode, L, hw)(
        torch.from_numpy(frames), torch.from_numpy(median), torch.from_numpy(starts).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_resize_runs_with_tf32_off(monkeypatch):
    matmul = torch.backends.cuda.matmul
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(matmul.allow_tf32)
        return real(a, b)

    monkeypatch.setattr(tpre.torch, "matmul", spy)
    before = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        tpre.resize_frames(torch.zeros((2, 8, 8, 3), dtype=torch.uint8), 4, 4)
        assert seen == [False, False]
        assert matmul.allow_tf32 is True  # given back after the block
        with tf32_off():
            assert matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert matmul.allow_tf32 is True
    finally:
        matmul.allow_tf32 = before
