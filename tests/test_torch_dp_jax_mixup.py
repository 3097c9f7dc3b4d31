"""Sample mixup across shares: the port's 2-share TrackNet step against the
JAX package's sharded step (``tests/torch_dp_jax.py``) in float64, with the
``perm`` / ``lam`` that the JAX step draws for the global batch (some
partners on the other share), held to ``tests/test_torch_steps.py``'s
one-device bounds; the three deliberately wrong steps (each share with its
own BatchNorm statistics, ``dgamma`` / ``dbeta`` from the summed sums, the
partner drawn inside the share) must fail those bounds. Then both mixups
at once (frame mixup's materialised labels mixed with the partner rows'
labels) over 4 shares, on pixel weights in quarters, for the reason
``test_torch_dp_jax_inpaint.py`` gives."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from test_torch_dp_batchnorm import WRONG_STEPS  # noqa: E402
from torch_dp_data import run_tracknet, tracknet_batch  # noqa: E402
from torch_dp_jax import failures, port_tracknet, tracknet_init, tracknet_sharded_step  # noqa: E402


@pytest.fixture(scope="module")
def init_vars():
    return tracknet_init()


@pytest.fixture(scope="module")
def sample_mixup(init_vars):
    batch = tracknet_batch("plain", 4, seed=12)
    want, perm, lam = tracknet_sharded_step(init_vars, batch, 2, 0.5)
    return batch, want, perm, lam


def test_sample_mixup_across_shares_matches_jax(init_vars, sample_mixup):
    batch, want, perm, lam = sample_mixup
    assert np.any(perm // 2 != np.arange(4) // 2)  # a partner on the other share
    got = run_tracknet(port_tracknet(init_vars), batch, 2, 0.5, perm, lam)
    assert failures(got, want) == []


@pytest.mark.parametrize("wrong", sorted(WRONG_STEPS))
def test_wrong_steps_fail_the_jax_bounds(init_vars, sample_mixup, wrong):
    batch, want, perm, lam = sample_mixup
    with WRONG_STEPS[wrong]():
        got = run_tracknet(port_tracknet(init_vars), batch, 2, 0.5, perm, lam)
    assert failures(got, want) != []


def test_both_mixups_over_four_shares_match_jax(init_vars):
    batch = tracknet_batch("frame_mixup", 4, seed=13, exact_blend=True)
    want, perm, lam = tracknet_sharded_step(init_vars, batch, 4, 0.5, key_seed=1)
    assert np.any(perm != np.arange(4))
    got = run_tracknet(port_tracknet(init_vars), batch, 4, 0.5, perm, lam)
    assert failures(got, want) == []
