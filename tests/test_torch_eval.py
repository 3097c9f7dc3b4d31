"""The port's validation loop and metrics vs the JAX package's.

``eval_tracknet`` of both packages reads the same heatmaps and labels
through a fixed eval step: equal mean loss and equal 5-way confusion, with
the repeated frame ids of a padded window counted once; with
``exact_decode`` (the largest-bbox-area rule on the device or on the host)
too, on heatmaps where a larger, dimmer blob sits beside the bright one. The metric helpers
(``gt_center_from_label``, ``classify_detections``, ``get_metric``) give the
JAX package's values on random inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import jax.numpy as jnp  # noqa: E402

from tracknetv3_tpu.evaluation import metrics as jax_metrics  # noqa: E402
from tracknetv3_tpu.evaluation.loops import eval_tracknet as jax_eval_tracknet  # noqa: E402
from tracknetv3_tpu_torch.evaluation import metrics  # noqa: E402
from tracknetv3_tpu_torch.evaluation.loops import eval_tracknet  # noqa: E402

B, L, H, W = 3, 4, 40, 72


def _batches(seed):
    """Three batches: blobs on, near, far from or without the label."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(3):
        cx = rng.integers(3, W - 3, (B, L))
        cy = rng.integers(3, H - 3, (B, L))
        no_ball = rng.random((B, L)) < 0.25
        cx[no_ball] = cy[no_ball] = 0
        probs = (rng.random((B, H, W, L)) * 0.4).astype(np.float32)
        for b in range(B):
            for t in range(L):
                shift = rng.choice([0, 2, 9, -1])  # -1: no blob
                if shift < 0:
                    continue
                bx = int(cx[b, t] or rng.integers(3, W - 3)) + shift
                by = int(cy[b, t] or rng.integers(3, H - 3))
                probs[b, (yy - by) ** 2 + (xx - bx) ** 2 <= 6, t] = 0.9
        ids = np.stack([np.full((B, L), i), np.tile(np.arange(L), (B, 1))], -1)
        ids[-1, -2:] = ids[-1, -3]  # a padded window repeats its last frame
        out.append({"cxcy": np.stack([cx, cy], -1).astype(np.int32),
                    "id": ids.astype(np.int32), "probs": probs,
                    "loss": np.float32(rng.random())})
    return out


@pytest.mark.parametrize("seed,tolerance", [(0, 4.0), (1, 2.0)])
def test_eval_tracknet_matches_jax(seed, tolerance):
    batches = _batches(seed)
    want_loss, want = jax_eval_tracknet(
        None, lambda state, b: (b["loss"], jnp.asarray(b["probs"])), batches, tolerance
    )
    got_loss, got = eval_tracknet(
        lambda b: (torch.tensor(b["loss"]), torch.from_numpy(b["probs"])), batches, tolerance
    )
    assert got_loss == pytest.approx(want_loss, rel=1e-12)
    assert got == want
    counted = sum(got[k] for k in ("TP", "TN", "FP1", "FP2", "FN"))
    assert counted == 3 * (B * L - 2)  # each batch's two padded repeats are not counted
    assert min(got["TP"], got["TN"], got["FP1"], got["FP2"], got["FN"]) > 0


@pytest.mark.parametrize("exact_decode", ["device", "host"])
def test_eval_tracknet_exact_decode_matches_jax(exact_decode):
    batches = _batches(3)
    for b in batches:  # a larger, dimmer blob away from the bright one in half the frames
        b["probs"][:, 30:36, 2:14, ::2] = 0.6
    kw = dict(tolerance=4.0, exact_decode=exact_decode)
    want_loss, want = jax_eval_tracknet(
        None, lambda state, b: (b["loss"], jnp.asarray(b["probs"])), batches, **kw)
    step = lambda b: (torch.tensor(b["loss"]), torch.from_numpy(b["probs"]))  # noqa: E731
    got_loss, got = eval_tracknet(step, batches, **kw)
    assert got_loss == pytest.approx(want_loss, rel=1e-12)
    assert got == want
    assert got != eval_tracknet(step, batches, 4.0)[1]  # the rule changed the confusion


def test_metric_helpers_match_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1280, 200)
    y = rng.uniform(0, 720, 200)
    x[:20] = y[:20] = 0
    x[20:25], y[20:25] = 1279.9, 719.9  # disks clipped at the border
    for args in ((x, y, 2.5, 2.5), (x, y, 1.0, 1.0)):
        for got, want in zip(metrics.gt_center_from_label(*args),
                             jax_metrics.gt_center_from_label(*args)):
            np.testing.assert_array_equal(got, want)
    pred = rng.integers(0, 40, (4, 200))
    pred[:, ::7] = 0
    for tol in (0.0, 4.0):
        np.testing.assert_array_equal(
            metrics.classify_detections(*pred, tolerance=tol),
            jax_metrics.classify_detections(*pred, tolerance=tol),
        )
    for counts in ((5, 3, 1, 2, 4), (0, 0, 0, 0, 0), (0, 7, 0, 0, 0)):
        assert metrics.get_metric(*counts) == jax_metrics.get_metric(*counts)
