"""The port's frame-mixup planner (``data/frame_mixup.py``) vs the JAX
package's: the same seeded generator gives the same plan, field by field
and dtype by dtype, and leaves both generators in the same state (the order
of the ``beta`` and ``choice`` draws is the contract that keeps the two
loaders' batches equal)."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from tracknetv3_tpu.data import frame_mixup as jax_fm  # noqa: E402
from tracknetv3_tpu_torch.data import frame_mixup as fm  # noqa: E402

FIELDS = ("frame_pair", "pix_w", "centers", "hm_w", "coor", "vis")


def _window(case: str, L: int, rng):
    """Label coordinates and visibility of one window."""
    coor = np.stack([rng.uniform(50, 1200, L), rng.uniform(50, 700, L)], -1).astype(np.float32)
    vis = np.ones(L, np.float32)
    if case == "occluded":  # the carried-heatmap rule
        vis[[1, L - 1]] = 0
        coor[[1, L - 1]] = 0
    elif case == "starts_hidden":  # prev_vis == 0: no blend
        vis[0] = 0
        coor[0] = 0
    elif case == "slow":  # the ball moves < 10 px: no blend
        coor = coor[:1] + np.arange(L, dtype=np.float32)[:, None]
    return coor, vis


@pytest.mark.parametrize("case", ["moving", "occluded", "starts_hidden", "slow"])
@pytest.mark.parametrize("L", [3, 8])
def test_plan_equals_jax(case, L):
    coor, vis = _window(case, L, np.random.default_rng(L))
    for seed in range(5):
        r_jax, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_fm.plan_frame_mixup(coor, vis, 2.5, 2.5, 0.5, r_jax)
        got = fm.plan_frame_mixup(coor, vis, 2.5, 2.5, 0.5, r_port)
        assert tuple(f.name for f in dataclasses.fields(got)) == FIELDS
        for k in FIELDS:
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        # both generators are left where the next window's draws start
        assert r_jax.random() == r_port.random()


def test_plan_shapes_and_ranges():
    L = 8
    coor, vis = _window("moving", L, np.random.default_rng(0))
    p = fm.plan_frame_mixup(coor, vis, 2.5, 2.5, 0.5, np.random.default_rng(1))
    assert p.frame_pair.shape == (L, 2) and p.frame_pair.dtype == np.int32
    assert p.centers.shape == (L, 2, 2) and p.centers.dtype == np.int32
    assert p.frame_pair.min() >= 0 and p.frame_pair.max() < L
    assert np.all((p.pix_w >= 0) & (p.pix_w <= 1)) and np.all((p.hm_w >= 0) & (p.hm_w <= 1))
    # a slot is a real frame (ja == jb, weight 1) or a blend of neighbours
    real = p.frame_pair[:, 0] == p.frame_pair[:, 1]
    assert np.all(p.pix_w[real] == 1.0)
    assert np.all(p.frame_pair[~real, 1] - p.frame_pair[~real, 0] == 1)
