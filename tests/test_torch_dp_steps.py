"""The port's data-parallel train steps over W shares of a CPU mesh against
its one-device step on the global batch, in float64 (the step's function is
the single step's; only the order of the cross-share sums differs).

For W = 2 and 4 and each batch kind (plain, segmented, resident frames,
frame mixup, sample mixup with every partner on another share, both mixups)
and for InpaintNet: one Adam step from the same weights; the loss, every
gradient, the running statistics and the updated parameters within 1e-10
relative L2 (``test_torch_dp_batchnorm.py`` shows that three deliberately
wrong steps fail it).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from torch_dp_data import (  # noqa: E402
    crossing_mixup,
    inpaintnet_batch,
    inpaintnet_model,
    run_inpaintnet,
    run_tracknet,
    tracknet_batch,
    tracknet_model,
    worst,
)

BOUND = 1e-10
B = 4

CASES = [  # (kind, alpha, W): segments of 2 windows split in 2 shares at batch 4
    ("plain", 0.0, 2), ("plain", 0.0, 4), ("segmented", 0.0, 2), ("resident", 0.0, 2),
    ("resident", 0.0, 4), ("frame_mixup", 0.0, 2), ("frame_mixup", 0.0, 4),
    ("plain", 0.5, 2), ("plain", 0.5, 4), ("segmented", 0.5, 2), ("frame_mixup", 0.5, 2),
    ("frame_mixup", 0.5, 4),
]


@functools.lru_cache(maxsize=None)
def _one_device(kind, alpha):
    perm, lam = crossing_mixup(B) if alpha > 0 else (None, None)
    return run_tracknet(tracknet_model(), tracknet_batch(kind, B), None, alpha, perm, lam)


def _pair(kind, alpha, W):
    """(W-share step, one-device step) from the same weights."""
    perm, lam = crossing_mixup(B) if alpha > 0 else (None, None)
    got = run_tracknet(tracknet_model(), tracknet_batch(kind, B), W, alpha, perm, lam)
    return got, _one_device(kind, alpha)


@pytest.mark.parametrize("kind,alpha,W", CASES)
def test_shares_step_equals_the_one_device_step(kind, alpha, W):
    got, want = _pair(kind, alpha, W)
    errs = worst(got, want)
    assert all(e <= BOUND for e, _ in errs.values()), errs
    # the step moved something, and the statistics are the batch's
    assert np.abs(got["param:predictor.bias"]).max() > 0
    assert np.abs(got["stat:down_block_1.conv_1.bn.running_mean"]).max() > 0


@pytest.mark.parametrize("W", [2, 4])
def test_inpaintnet_shares_step_equals_the_one_device_step(W):
    batch = inpaintnet_batch(B, 3)
    mask = (np.random.default_rng(4).random((B, 3, 1)) < 0.5).astype(np.float32)
    # a clip norm under this gradient's (0.028), so that the clip acts: on
    # the summed gradient, or the shares would differ from one device
    want = run_inpaintnet(inpaintnet_model(), batch, mask, clip_norm=0.01)
    got = run_inpaintnet(inpaintnet_model(), batch, mask, W, clip_norm=0.01)
    errs = worst(got, want)
    assert all(e <= BOUND for e, _ in errs.values()), errs
    norm = np.sqrt(sum(np.sum(v ** 2) for k, v in got.items() if k.startswith("grad:")))
    assert norm == pytest.approx(0.01, rel=1e-6)
