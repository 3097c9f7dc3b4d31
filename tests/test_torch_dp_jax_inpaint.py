"""The port's data-parallel steps against the JAX package's sharded steps
(``tests/torch_dp_jax.py``) in float64: TrackNet on a frame-mixup batch
over 2 shares (each share blends its own rows' frames on its entry), and
InpaintNet (seq_len 3, batch 4, mask ratio 0.3, Adam clipped at 1.0) over 2
shares with the mask the JAX step draws for the global batch, each share
taking its rows. TrackNet is held to ``tests/test_torch_steps.py``'s
one-device bounds; InpaintNet to ``test_torch_inpaintnet_train.py``'s
float64 bound, 1e-10 relative L2 on the loss, every gradient and every
parameter.

The frame-mixup batch blends with pixel weights in quarters
(``exact_blend``): XLA contracts one product of the float32 blend into a
fused multiply-add (``test_torch_steps.py`` bounds the inputs' difference
at 2 spacings), and at batch 4 train-mode BatchNorm amplifies that into a
gradient 3e-3 off in relative L2, for the port's one-device step as for its
shares (both measured on this batch with random weights): with exact
products the two packages' inputs are equal and the comparison is of the
data-parallel step. ``test_torch_dp_steps.py`` holds the shares to one
device on random weights."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from torch_dp_data import (  # noqa: E402
    inpaintnet_batch,
    rel_err,
    run_inpaintnet,
    run_tracknet,
    tracknet_batch,
)
from torch_dp_jax import (  # noqa: E402
    failures,
    inpaintnet_init,
    inpaintnet_sharded_step,
    port_inpaintnet,
    port_tracknet,
    tracknet_init,
    tracknet_sharded_step,
)


def test_frame_mixup_shares_step_matches_jax():
    init_vars = tracknet_init()
    batch = tracknet_batch("frame_mixup", 4, seed=14, exact_blend=True)
    want, _, _ = tracknet_sharded_step(init_vars, batch, 2, 0.0)
    got = run_tracknet(port_tracknet(init_vars), batch, 2)
    assert failures(got, want) == []


def test_inpaintnet_shares_step_matches_jax():
    init_vars = inpaintnet_init()
    batch = inpaintnet_batch(4, seed=15)
    want, mask = inpaintnet_sharded_step(init_vars, batch, 2)
    assert 0 < mask.sum() < mask.size
    got = run_inpaintnet(port_inpaintnet(init_vars), batch, mask, 2)
    errs = {k: rel_err(got[k], w) for k, w in want.items()}
    assert max(errs.values()) <= 1e-10, max(errs.items(), key=lambda kv: kv[1])
