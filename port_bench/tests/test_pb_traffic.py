"""The traffic is a function of the seed: the same seed gives the same
clips, offsets and mixup draws, and every seed serves the same lengths."""

from __future__ import annotations

import itertools
import json
import os
from collections import Counter

import numpy as np

from conftest import BENCH_DIR

SEED = 2**31 + 12345  # more than 32 signed bits hold


def _mix(name):
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def test_clip_lengths_are_the_test_rallies():
    """The 29 rally videos of the dataset's test split, by frame count."""
    from benchkit.traffic import clip_lengths

    length = _mix("rally_clips")["length"]
    lengths = clip_lengths(length)
    assert len(lengths) == 29 and lengths == sorted(length["frames"])
    assert lengths[0] == 133 and lengths[-1] == 779 and sum(lengths) == 12656
    assert "corrected_test_label" in length["source"]


def test_the_sequence_is_the_seeds_and_every_cycle_serves_every_length():
    from benchkit.traffic import clip_lengths, clip_sequence

    tr = _mix("rally_clips")
    lengths = clip_lengths(tr["length"])
    n, k = len(lengths), tr["length"]["strata"]

    def first(seed, m):
        return list(itertools.islice(clip_sequence(tr["length"], tr["pool_frames"], seed), m))

    a, b, c = first(SEED, 3 * n), first(SEED, 3 * n), first(SEED + 1, 3 * n)
    assert a == b and a != c
    for seq in (a, c):
        for cycle in range(3):
            part = seq[cycle * n:(cycle + 1) * n]
            assert Counter(x for x, _ in part) == Counter(lengths)
            assert all(0 <= off <= tr["pool_frames"] - x for x, off in part)
    # each block of a cycle holds one length of each stratum of the sorted
    # list that still has one: strata of 6, 6, 6, 6 and 5 lengths
    strata = [list(g) for g in np.array_split(np.asarray(lengths), k)]
    assert [len(g) for g in strata] == [6, 6, 6, 6, 5]
    for cycle in range(3):
        pos = cycle * n
        for blk in range(len(strata[0])):
            size = sum(blk < len(g) for g in strata)
            block = [x for x, _ in a[pos:pos + size]]
            assert all(sum(x in g for x in block) == 1 for g in strata if blk < len(g))
            pos += size


def test_mixup_and_weight_seeds():
    from benchkit.traffic import mixup_rng, torch_seed

    assert (mixup_rng(SEED, 7).random(4) == mixup_rng(SEED, 7).random(4)).all()
    assert (mixup_rng(SEED, 7).random(4) != mixup_rng(SEED, 8).random(4)).all()
    assert torch_seed(SEED, 2) == torch_seed(SEED, 2) != torch_seed(SEED, 3)
    assert 0 <= torch_seed(-5, 2) < 2**63


def test_weights_and_pool_are_the_seeds():
    import torch

    from benchkit import scene, weights

    a = weights.tracknet_state(3, "", 11, "cpu")
    b = weights.tracknet_state(3, "", 11, "cpu")
    c = weights.tracknet_state(3, "", 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["bottleneck.conv_1.conv.weight"], c["bottleneck.conv_1.conv.weight"])
    p1, p2 = scene.yuv_pool(5, 50, 16, 32, "cpu"), scene.yuv_pool(5, 50, 16, 32, "cpu")
    assert p1.shape == (50, 16 * 32 * 3 // 2) and (p1 == p2).all()
    assert (p1[:10] == p1[scene.PERIOD:scene.PERIOD + 10]).all()  # the pass repeats
