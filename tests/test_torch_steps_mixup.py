"""The port's TrackNet train step on segmented and frame-mixup batches vs the
JAX package's, on the CPU at 32x64, seq_len 3, batch 2: one float64 Adam
step from the same weights and batch, with and without sample mixup, at the
tolerances of ``test_torch_steps.py`` (whose helpers and batches this file
uses; the steps are a file of their own so that the suite's workers share
them). The JAX step takes its Pallas loss in interpret mode; with both
mixups on it falls back to materialised labels, and so does the port."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

from test_torch_steps import (  # noqa: E402
    _check_step_matches_jax,
    _frame_mixup_batch,
    _segmented_batch,
    init_vars,  # noqa: F401  (the module's fixture)
)


@pytest.mark.parametrize("kind,alpha", [("segmented", 0.0), ("segmented", 0.5),
                                        ("frame_mixup", 0.0), ("frame_mixup", 0.5)])
def test_adam_step_on_segmented_and_frame_mixup_batches_matches_jax(init_vars, kind, alpha):
    batch = _segmented_batch(7) if kind == "segmented" else _frame_mixup_batch(8)
    _check_step_matches_jax(init_vars, batch, "float64", alpha=alpha, pallas=True)
