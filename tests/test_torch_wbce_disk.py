"""The port's fused WBCE loss (plain path on the CPU) vs the JAX package's
``wbce_disk_loss`` with its Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and fed to both. Loss rtol 1e-6,
dz atol 1e-7 (dz values are ~1e-5: each element's gradient is divided by
B*H*W*L), for all three target packers, with logits reaching the clamp.
The CUDA kernels themselves are checked against the same plain version on
the card by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.ops import pallas_wbce as pw  # noqa: E402
from tracknetv3_tpu_torch.ops import wbce_disk as wd  # noqa: E402
from tracknetv3_tpu_torch.utils import profiling  # noqa: E402

B, H, W, L = 2, 32, 128, 3
SIGMA = 2.5


def _logits(seed, scale=5.0):
    # scale 5 puts ~0.1% of the logits past the clamp (|z| > 16.12)
    return (np.random.default_rng(seed).standard_normal((B, H, W, L)) * scale).astype(np.float32)


def _centers(seed):
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, W, (B, L))
    cy = rng.integers(0, H, (B, L))
    cx[0, 1] = cy[0, 1] = 0  # one frame without a ball
    return np.stack([cx, cy], axis=-1).astype(np.int32)


def _targets(kind, seed):
    rng = np.random.default_rng(seed + 100)
    if kind == "plain":
        c = _centers(seed)
        return (pw.pack_plain_targets(jnp.asarray(c)),
                wd.pack_plain_targets(torch.from_numpy(c)))
    if kind == "mixup":
        c = _centers(seed)
        perm = np.array([1, 0])
        lam = rng.uniform(0.5, 1.0, B).astype(np.float32)
        return (pw.pack_mixup_targets(jnp.asarray(c), jnp.asarray(perm), jnp.asarray(lam)),
                wd.pack_mixup_targets(torch.from_numpy(c), torch.from_numpy(perm),
                                      torch.from_numpy(lam)))
    centers = rng.integers(1, 30, size=(B, L, 2, 2)).astype(np.int32)
    hm_w = rng.uniform(0, 1, size=(B, L)).astype(np.float32)
    return (pw.pack_frame_mixup_targets(jnp.asarray(centers), jnp.asarray(hm_w)),
            wd.pack_frame_mixup_targets(torch.from_numpy(centers), torch.from_numpy(hm_w)))


@pytest.mark.parametrize("kind", ["plain", "mixup", "frame_mixup"])
def test_loss_and_grad_match_jax_kernel(kind):
    z = _logits(seed={"plain": 0, "mixup": 1, "frame_mixup": 2}[kind])
    (jc, jw), (tc, tw) = _targets(kind, seed=3)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_allclose(np.asarray(jw), tw.numpy(), rtol=0, atol=0)

    want, g_want = jax.value_and_grad(
        lambda x: pw.wbce_disk_loss(x, jc, jw, SIGMA, True)
    )(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    got = wd.wbce_disk_loss(zt, tc, tw, SIGMA)
    got.backward()

    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(g_want), rtol=0, atol=1e-7)


def test_packers_layouts():
    c = torch.from_numpy(_centers(5))
    cxcy2, w = wd.pack_plain_targets(c)
    assert cxcy2.shape == (B, 2, 2, L) and cxcy2.dtype == torch.int32
    assert w.shape == (B, 1, L) and bool((w == 1).all())
    flat, wf = wd.flatten_targets(cxcy2, w)
    assert flat.shape == (B, 4 * L) and wf.shape == (B, L)
    # [cxa | cya | cxb | cyb]
    np.testing.assert_array_equal(flat[:, :L].numpy(), c[..., 0].numpy())
    np.testing.assert_array_equal(flat[:, L:2 * L].numpy(), c[..., 1].numpy())


def test_gradient_finite_at_saturation():
    (_, _), (tc, tw) = _targets("plain", seed=0)
    z = torch.full((B, H, W, L), 40.0, requires_grad=True)
    wd.wbce_disk_loss(z, tc, tw).backward()
    assert torch.isfinite(z.grad).all()


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    before = profiling.counters()
    (_, _), (tc, tw) = _targets("plain", seed=0)
    z = torch.from_numpy(_logits(4))
    assert torch.equal(wd.wbce_disk_loss(z, tc, tw), wd.wbce_disk_loss_plain(z, tc, tw))
    assert profiling.counters() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    (_, _), (tc, tw) = _targets("plain", seed=0)
    z = torch.zeros(B, L, H, W)
    c, w = wd.flatten_targets(tc, tw)
    with pytest.raises(ValueError, match="CUDA"):
        wd.wbce_disk_forward(z, c, w)
    with pytest.raises(ValueError, match="CUDA"):
        wd.wbce_disk_backward(z, c, w, torch.ones(()))

