"""Videos, checkpoints and predictors for the serving parity tests of the
PyTorch port (``tests/test_torch_serve_resident.py``,
``test_torch_streaming.py``, ``test_torch_batch_serving.py``,
``test_torch_predict_cli.py``).

Clips are mp4 files written with cv2 at twice the 32x64 model resolution
(a textured background, a bright square moving across it), so every path
scales coordinates. The TrackNet checkpoints are JAX random inits whose
predictor is scaled and shifted so that about 2% of the clip's pixels pass
0.5 (``detecting_checkpoint``): the rows compared hold detections. Both
packages serve at float32 and read video with cv2 (``native_decode=False``,
``jax_predictor``, ``PORT_ARGS``, ``port_predictor``); the native decoder's parity is in
``tests/test_torch_native_*.py``.
"""

import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import torch

import tracknetv3_tpu.inference as jinf
from tracknetv3_tpu.models import get_model as jax_get_model
from tracknetv3_tpu.training.checkpoint import save_checkpoint
from tracknetv3_tpu_torch import inference as tinf
from tracknetv3_tpu_torch.models.fused_forward import tracknet_fused_forward
from tracknetv3_tpu_torch.ops.preprocess import make_window_preprocessor

H, W, L, B = 32, 64, 3, 4  # model resolution, seq_len, batch
PASS_SHARE = 0.02  # share of the clip's logits that pass 0.5
JaxPredictor = jinf.TrackNetPredictor
# what the JAX entry points make when a test sets jinf.TrackNetPredictor to it
JAX_F32 = functools.partial(JaxPredictor, compute_dtype=jnp.float32)


def write_clip(path: str, n: int, seed: int, sh: int = 2 * H, sw: int = 2 * W,
               fps: float = 30) -> str:
    """An mp4 of ``n`` frames (sw x sh) at ``fps``: a green ramp under red
    and blue noise, a 6x6 white square moving across it."""
    rng = np.random.default_rng(seed)
    base = np.zeros((sh, sw, 3), np.uint8)
    base[:, :, 0] = rng.integers(0, 120, (sh, sw), dtype=np.uint8)
    base[:, :, 1] = np.linspace(30, 200, sw, dtype=np.uint8)[None, :]
    base[:, :, 2] = rng.integers(0, 30, (sh, sw), dtype=np.uint8)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (sw, sh))
    for t in range(n):
        f = base.copy()
        y, x = 4 + (3 * t) % (sh - 12), 4 + (5 * t) % (sw - 12)
        f[y : y + 6, x : x + 6] = 255
        vw.write(f[..., ::-1])
    vw.release()
    return path


def read_rgb(path: str) -> np.ndarray:
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return np.stack(frames)


def detecting_checkpoint(path: str, bg_mode: str, clip: str, seed: int = 0) -> str:
    """A JAX random init of TrackNet (seq_len L, ``bg_mode``) whose
    predictor kernel is scaled by 40 and whose bias is set so that
    ``PASS_SHARE`` of the logits of the clip's windows (resized on the
    device-resize path) pass 0.5."""
    _, tv = jax_get_model("TrackNet", L, bg_mode, rng=jax.random.PRNGKey(seed))
    tv = jax.tree_util.tree_map(np.array, tv)
    tv["params"]["predictor"]["kernel"] *= 40.0
    tv["params"]["predictor"]["bias"][:] = 0.0
    pd = dict(model_name="TrackNet", seq_len=L, bg_mode=bg_mode)
    save_checkpoint(path, epoch=0, max_val_acc=0.0, model=tv, param_dict=pd)
    p = tinf.TrackNetPredictor(path, compute_dtype=torch.float32, input_hw=(H, W), device="cpu")
    frames = torch.from_numpy(read_rgb(clip))
    med = frames.to(torch.float32).median(dim=0).values
    x = make_window_preprocessor(bg_mode, L, (H, W))(frames, med, torch.arange(len(frames) - L))
    logits = tracknet_fused_forward(p.params, x, apply_sigmoid=False).flatten()
    tv["params"]["predictor"]["bias"][:] = -float(torch.quantile(logits, 1 - PASS_SHARE))
    save_checkpoint(path, epoch=0, max_val_acc=0.0, model=tv, param_dict=pd)
    return path


def inpaint_checkpoint(path: str) -> str:
    _, iv = jax_get_model("InpaintNet", 16, rng=jax.random.PRNGKey(1))
    save_checkpoint(path, epoch=0, max_val_acc=0.0, model=iv,
                    param_dict=dict(model_name="InpaintNet", seq_len=16))
    return path


def jax_predictor(tn: str, eval_mode: str = "weight", inp=None, batch_size: int = B):
    return JaxPredictor(tn, inp, eval_mode=eval_mode, batch_size=batch_size,
                                  input_hw=(H, W), compute_dtype=jnp.float32,
                                  native_decode=False, stage_format="bgr")


# the port's serving settings here, as ``predict_video`` takes them
PORT_ARGS = {"batch_size": B, "input_hw": (H, W), "compute_dtype": torch.float32, "device": "cpu",
             "native_decode": False}


def port_predictor(tn: str, eval_mode: str = "weight", inp=None, batch_size: int = B):
    return tinf.TrackNetPredictor(tn, inp, eval_mode=eval_mode, batch_size=batch_size,
                                  input_hw=(H, W), compute_dtype=torch.float32, device="cpu",
                                  native_decode=False)


def visible(pred) -> int:
    return int(sum(pred["Visibility"]))


def csv_text(path: str) -> str:
    with open(path) as f:
        return f.read()


def names(directory: str):
    return sorted(os.listdir(directory))
