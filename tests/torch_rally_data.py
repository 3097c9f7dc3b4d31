"""A tiny rally dataset, checkpoints and engine helpers for the
rally-evaluation parity tests of the PyTorch port
(``tests/test_torch_test_engine*.py``, ``tests/test_torch_*_cli.py``).

Layout of the Shuttlecock Trajectory Dataset at 64x128 source PNGs (twice
the 32x64 model resolution, so the source scaling is exercised): a test
split of one match with two rallies (corrected labels, a drop-frame window)
and a train split of one match with one rally; a match median for the
concat mode. The TrackNet checkpoint is a JAX random init whose predictor
is scaled so that a few percent of pixels pass 0.5 in scattered blobs (the
exact and the peak-blob decoders then disagree on some frames). Both
packages' engines run at float32: the JAX forward through
``tracknet_fused_forward`` patched to float32 (``_forward_cached`` imports it
at call time, ``jax_f32``), the port with ``compute_dtype=torch.float32``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import tracknetv3_tpu.models.fused_forward as jax_ff
from tracknetv3_tpu.data.dataset import FrameCache as JaxFrameCache
from tracknetv3_tpu.evaluation.test_engine import RallyTestEngine as JaxEngine
from tracknetv3_tpu.models import get_model as jax_get_model
from tracknetv3_tpu.training.checkpoint import load_model_from_checkpoint as jax_load
from tracknetv3_tpu.training.checkpoint import save_checkpoint
from tracknetv3_tpu_torch.data.dataset import FrameCache
from tracknetv3_tpu_torch.evaluation.test_engine import RallyTestEngine
from tracknetv3_tpu_torch.training.checkpoint import load_model_from_checkpoint

H, W, L, B = 32, 64, 3, 4  # model resolution, seq_len, batch
RALLIES = {"test": (("1_01_00", 22), ("1_02_00", 9)), "train": (("1_01_00", 12),)}
DROP = {"start": {"1_1_01_00": 2, "1_1_02_00": 1}, "end": {"1_1_01_00": 19, "1_1_02_00": 9}}


def write_dataset(root: str, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 120, (2 * H, 2 * W, 3), np.uint8)
    for split, rallies in RALLIES.items():
        match_dir = os.path.join(root, split, "match1")
        csv_dir = os.path.join(match_dir, "corrected_csv" if split == "test" else "csv")
        os.makedirs(csv_dir, exist_ok=True)
        np.savez(os.path.join(match_dir, "median.npz"), median=bg.astype(np.float64))
        for rally, T in rallies:
            frame_dir = os.path.join(match_dir, "frame", rally)
            os.makedirs(frame_dir)
            xs = rng.integers(4, 2 * W - 4, T)
            ys = rng.integers(12, 2 * H - 4, T)
            vis = (rng.random(T) > 0.2).astype(int)
            for t in range(T):
                f = bg.copy()
                f[rng.random((2 * H, 2 * W)) < 0.01] = 255  # speckle: scattered blobs
                if vis[t]:
                    f[ys[t] - 3 : ys[t] + 3, xs[t] - 3 : xs[t] + 3] = 255
                Image.fromarray(f).save(os.path.join(frame_dir, f"{t}.png"))
            pd.DataFrame({"Frame": range(T), "Visibility": vis, "X": xs * vis,
                          "Y": ys * vis}).to_csv(os.path.join(csv_dir, f"{rally}_ball.csv"),
                                                 index=False)
    with open(os.path.join(root, "drop_frame.json"), "w") as f:
        json.dump(DROP, f)
    return root


def write_checkpoints(root: str):
    """(TrackNet, InpaintNet) checkpoints from JAX random inits."""
    _, tv = jax_get_model("TrackNet", L, "concat", rng=jax.random.PRNGKey(0))
    tv = jax.tree_util.tree_map(np.array, tv)
    tv["params"]["predictor"]["kernel"] *= 40.0
    tv["params"]["predictor"]["bias"][:] = -3.5
    tn = os.path.join(root, "TrackNet_best.pt")
    save_checkpoint(tn, epoch=0, max_val_acc=0.0, model=tv,
                    param_dict=dict(model_name="TrackNet", seq_len=L, bg_mode="concat",
                                    input_hw=[H, W]))
    _, iv = jax_get_model("InpaintNet", 16, rng=jax.random.PRNGKey(1))
    inp = os.path.join(root, "InpaintNet_best.pt")
    save_checkpoint(inp, epoch=0, max_val_acc=0.0, model=iv,
                    param_dict=dict(model_name="InpaintNet", seq_len=16))
    return tn, inp


def jax_f32() -> pytest.MonkeyPatch:
    """The JAX forward patched to float32; ``undo()`` the returned patch."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_ff, "tracknet_fused_forward",
               functools.partial(jax_ff.tracknet_fused_forward, dtype=jnp.float32))
    return mp


def engines(tn: str, inp=None, **kw):
    """(JAX engine, port engine on the CPU) on the same checkpoints, at the
    test size, float32."""
    kw = dict(tracknet_seq_len=L, bg_mode="concat", batch_size=B, input_hw=(H, W), **kw)
    jm, jv, _ = jax_load(tn)
    jax_inp = port_inp = None
    if inp:
        im, iv, _ = jax_load(inp)
        jax_inp = (im, iv)
        port_inp = load_model_from_checkpoint(inp)[0]
    port = RallyTestEngine(load_model_from_checkpoint(tn, dtype=torch.float32)[0], port_inp,
                           device="cpu", compute_dtype=torch.float32, **kw)
    return JaxEngine((jm, jv), jax_inp, **kw), port


def rally_dir(data: str, rally: str, split: str = "test") -> str:
    return os.path.join(data, split, "match1", "frame", rally)


def predict(engine, data: str, rally: str, T: int):
    """``predict_rally_heatmap`` over a test rally's T frames, with the
    frame cache of the engine's own package."""
    cache = (FrameCache if isinstance(engine, RallyTestEngine) else JaxFrameCache)(
        data, "concat", input_hw=(H, W))
    return engine.predict_rally_heatmap(cache, rally_dir(data, rally), np.arange(T))


def check_heatmap_rows(data: str, tn: str, eval_mode: str, exact_decode) -> None:
    """``predict_rally_heatmap`` of both packages on both test rallies:
    ``cx``, ``cy``, ``bbox`` bit-equal and int64, ``conf`` within 1e-5, and
    real detections among the rows."""
    je, te = engines(tn, eval_mode=eval_mode, exact_decode=exact_decode)
    visible = 0
    for rally, T in RALLIES["test"]:
        want = predict(je, data, rally, T)
        got = predict(te, data, rally, T)
        for k in ("cx", "cy", "bbox"):
            assert got[k].dtype == np.int64
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{rally} {k}")
        assert got["cx"].shape == (T,) and got["bbox"].shape == (T, 4)
        np.testing.assert_allclose(got["conf"], want["conf"], rtol=0, atol=1e-5)
        visible += int((got["cx"] > 0).sum())
    assert visible >= 10  # the comparison sees real detections


def port_engine_f32(monkeypatch) -> list:
    """Make the port's CLIs build their engine at float32; returns the list
    of the dtypes they asked for."""
    from tracknetv3_tpu_torch.evaluation import test_engine

    asked = []

    def engine_f32(*args, compute_dtype=None, **kwargs):
        asked.append(compute_dtype)
        return RallyTestEngine(*args, compute_dtype=torch.float32, **kwargs)

    monkeypatch.setattr(test_engine, "RallyTestEngine", engine_f32)
    return asked
