"""The port's data-parallel TrackNet step against the JAX package's sharded
step (``tests/torch_dp_jax.py``: ``make_mesh(W)`` on the conftest's virtual
CPU devices, state replicated, batch sharded), in float64 at 32x64, seq_len
3, batch 4: one Adam step from the same weights on plain (W = 2), segmented
(W = 2, a segment a share) and resident-frame (W = 4, the buffers replicated
on every entry, or the frames sharded over the entries as the loaders'
``frame_sharding="shard"`` places them on both sides) batches, held to the
bounds that ``tests/test_torch_steps.py``
holds the one-device step to (``torch_dp_jax.failures``). Sample and frame
mixup: ``test_torch_dp_jax_mixup.py``; InpaintNet:
``test_torch_dp_jax_inpaint.py``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from torch_dp_data import run_tracknet, tracknet_batch  # noqa: E402
from torch_dp_jax import failures, port_tracknet, tracknet_init, tracknet_sharded_step  # noqa: E402


@pytest.fixture(scope="module")
def init_vars():
    return tracknet_init()


@pytest.mark.parametrize("kind,W", [("plain", 2), ("segmented", 2), ("resident", 4),
                                    ("resident_shard", 4)])
def test_shares_step_matches_the_jax_sharded_step(init_vars, kind, W):
    batch = tracknet_batch(kind, 4, seed=11)
    shard = kind == "resident_shard"
    want, _, _ = tracknet_sharded_step(init_vars, batch, W, 0.0,
                                       frame_sharding="shard" if shard else "replicate")
    got = run_tracknet(port_tracknet(init_vars), batch, W, shard=shard)
    assert failures(got, want) == []
