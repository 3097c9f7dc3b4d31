"""Traffic from a mix's parameters and the run's seed.

Clip lengths: the mix's list of frame counts (``length.frames``), the same
for every seed. Each cycle serves every length once; the seed orders them
within strata of the sorted list (``strata`` blocks of sizes that differ
by one at most, one length of each stratum per block), so that every
prefix of the sequence holds nearly the same mix of short and long clips
and a window that ends mid-cycle does nearly the same work on every seed.
Each clip is a slice of the pool at an offset drawn from the seed.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np


def sub_seed(seed: int, *tags: int) -> np.random.SeedSequence:
    """A seed sequence of the run's ``seed`` (any whole number) and
    ``tags``."""
    return np.random.SeedSequence([int(seed) % (1 << 64)] + [int(t) for t in tags])


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a ``torch.Generator``."""
    return int(sub_seed(seed, *tags).generate_state(1, np.uint64)[0]) >> 1


def clip_lengths(length: Dict) -> List[int]:
    """The sorted clip lengths of the mix."""
    return sorted(int(v) for v in length["frames"])


def clip_sequence(length: Dict, pool_frames: int, seed: int) -> Iterator[Tuple[int, int]]:
    """Endless (length, pool offset) pairs: cycles of every length once,
    ordered within strata by the seed; offsets uniform in the pool."""
    lengths = clip_lengths(length)
    strata = int(length.get("strata", 1))
    if not 1 <= strata <= len(lengths) or lengths[-1] > pool_frames:
        raise ValueError(f"{len(lengths)} lengths up to {lengths[-1]} do not fit {strata} "
                         f"strata and a pool of {pool_frames} frames")
    rng = np.random.default_rng(sub_seed(seed, 1))
    groups = np.array_split(np.asarray(lengths), strata)  # the larger strata first
    while True:
        picks = [rng.permutation(g) for g in groups]
        for b in range(len(picks[0])):
            block = [int(p[b]) for p in picks if b < len(p)]
            for k in rng.permutation(len(block)):
                n = block[k]
                yield n, int(rng.integers(0, pool_frames - n + 1))


def mixup_rng(seed: int, step: int) -> np.random.Generator:
    """The generator of train step ``step``'s mixup draw, as the train loop
    seeds it (``default_rng([seed, step])``)."""
    return np.random.default_rng([int(seed) % (1 << 64), int(step)])
