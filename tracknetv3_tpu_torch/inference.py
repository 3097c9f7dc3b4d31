"""Single-video serving: frames -> TrackNet -> ensemble -> decode ->
InpaintNet -> CSV (the port of the JAX package's ``inference.py`` staged
path, ``predict_video`` and ``TrackNetPredictor``).

The pipeline, as in the JAX package:

1. stage: model-resolution uint8 frames go to the card in one copy from
   pinned host memory (``stage_frames``), and the exact per-pixel median
   background is taken there (all frames, capped at 4096, stride T//k);
2. ``run_staged``: chunks of ``batch_size`` windows, each one window
   gather + channel stack (``ops/preprocess.py``), the folded-BN TrackNet
   forward (``models/fused_forward.py``, pool/upsample kernels on the
   card), the carried-tail temporal ensemble (``ops/ensemble.py``) and the
   heatmap decode, packed ``[cx, cy, vis]`` rows kept on the card; then the
   ensemble flush and one fetch per video. ``nonoverlap`` forwards
   disjoint windows and decodes every frame of each;
3. ``inpaint_trajectory``: InpaintNet over windows of the normalised
   trajectory (padded to multiples of 64 windows), composited where the
   mask says, thresholded at ``COOR_TH``, ensembled, denormalised with the
   reference's float32 two-multiply;
4. ``write_pred_csv``.

Serving runs under ``torch.inference_mode()``. The JAX package's TPU
runtime machinery is not ported: bucket padding of the staged buffer, the
AOT program cache, meshes, streaming, ``device_resize``, the native libav
decoder and YUV420 staging raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from .config import COOR_TH, HEIGHT, WIDTH
from .device import resolve_device, tf32_off
from .models.fused_forward import fold_batchnorm, fused_params, tracknet_fused_forward
from .ops.detect import decode_heatmaps
from .ops.ensemble import (
    ensemble_chunk,
    ensemble_flush,
    ensemble_init,
    ensemble_update_fn,
    get_ensemble_weight,
)
from .ops.postprocess import generate_inpaint_mask
from .ops.preprocess import make_staged_preprocessor, median_of_u8_stack
from .training.checkpoint import load_model_from_checkpoint
from .utils.io import VideoReader, write_pred_csv


def zero_below_th(out: torch.Tensor) -> torch.Tensor:
    """InpaintNet coordinates (..., 2) with both below ``COOR_TH`` set to 0
    (no detection)."""
    th = (out[..., 0] < COOR_TH) & (out[..., 1] < COOR_TH)
    return torch.where(th[..., None], torch.zeros((), device=out.device), out)


class StagedVideo(NamedTuple):
    """A video staged on the card at model resolution."""

    buf: torch.Tensor  # (T, h, w, 3) uint8
    T: int
    median: Optional[torch.Tensor]  # (h, w, 3) float32, same channel order as buf
    bgr: bool  # buf and median hold BGR (flipped to RGB in the preprocessor)
    src_wh: Tuple[int, int]  # source (width, height) for coordinate scaling


def _refuse_unported(**options) -> None:
    """Raise ``NotImplementedError`` naming each option that is set."""
    bad = [k for k, v in options.items() if v]
    if bad:
        raise NotImplementedError(f"not ported to PyTorch yet: {', '.join(bad)}")


def _pack(dec: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([dec["cx"], dec["cy"], dec["vis"]], dim=-1).to(torch.int32)


class TrackNetPredictor:
    """Video -> trajectory predictor (TrackNet + optional InpaintNet).

    ``compute_dtype`` is the TrackNet working dtype (bfloat16 by default;
    float32 is the parity path and runs cuDNN without TF32). ``device``
    defaults to the card and raises without one; pass ``"cpu"`` to run the
    plain versions of the kernels on the CPU. ``conv_backend`` says who
    computes the folded forward's 3x3 convs: ``"cudnn"`` or the
    hand-written kernels ``"hand_k3c"`` / ``"hand_9tap"``
    (``ops/conv3x3.py``; bfloat16 only on the card); unset, the rule of
    ``models.fused_forward.resolve_conv_backend`` picks it.
    """

    def __init__(
        self,
        tracknet_file: str,
        inpaintnet_file: Optional[str] = None,
        eval_mode: str = "weight",
        batch_size: int = 16,
        compute_dtype: Optional[torch.dtype] = None,
        input_hw: Optional[Tuple[int, int]] = None,
        device: Optional[Union[str, torch.device]] = None,
        conv_backend: Optional[str] = None,
    ):
        if eval_mode not in ("nonoverlap", "average", "weight"):
            raise ValueError(f"Invalid eval_mode: {eval_mode!r}")
        self.device = resolve_device(device)
        self.h, self.w = (int(input_hw[0]), int(input_hw[1])) if input_hw else (HEIGHT, WIDTH)
        self.compute_dtype = compute_dtype if compute_dtype is not None else torch.bfloat16
        tracknet, tn_pd = load_model_from_checkpoint(tracknet_file, dtype=torch.float32)
        self.params = fused_params(fold_batchnorm(tracknet), self.compute_dtype, self.device,
                                   conv_backend)
        self.seq_len = int(tn_pd["seq_len"])
        self.bg_mode = tn_pd.get("bg_mode", "")
        self.eval_mode = eval_mode
        self.batch_size = int(batch_size)
        weights = get_ensemble_weight(
            self.seq_len, eval_mode if eval_mode != "nonoverlap" else "average"
        )
        self._weights = torch.from_numpy(weights).to(self.device)
        self.inpaintnet = None
        if inpaintnet_file:
            model, in_pd = load_model_from_checkpoint(inpaintnet_file)
            self.inpaintnet = model.to(self.device).eval()
            self.inpaintnet_seq_len = int(in_pd.get("seq_len", 16))

    # ------------------------------------------------------------ staging

    def stage_frames(
        self,
        frames_u8: np.ndarray,
        bgr: bool = False,
        src_wh: Optional[Tuple[int, int]] = None,
        max_sample_num: Optional[int] = None,
    ) -> StagedVideo:
        """Stage (T, h, w, 3) uint8 frames already at model resolution: one
        copy from pinned host memory, then the median background on the card
        (``bg_mode`` needs one). ``src_wh`` is the source video's (width,
        height), the model resolution by default."""
        frames_u8 = np.ascontiguousarray(frames_u8)
        if frames_u8.dtype != np.uint8 or frames_u8.shape[1:] != (self.h, self.w, 3):
            raise ValueError(f"need (T, {self.h}, {self.w}, 3) uint8 frames, got "
                             f"{frames_u8.dtype} {frames_u8.shape}")
        T = int(frames_u8.shape[0])
        if T == 0:
            raise ValueError("no frames to stage: the video yielded zero frames")
        host = torch.from_numpy(frames_u8)
        if self.device.type == "cuda":
            buf = host.pin_memory().to(self.device, non_blocking=True)
        else:
            buf = host.to(self.device)
        median = self._median_staged(buf, max_sample_num) if self.bg_mode else None
        return StagedVideo(buf, T, median, bgr, src_wh or (self.w, self.h))

    @staticmethod
    def _median_staged(buf: torch.Tensor, max_sample_num: Optional[int]) -> torch.Tensor:
        """Exact ``np.median`` background over the staged frames: all of
        them by default, else ``max_sample_num`` (at most 4096) frames at a
        stride of T // k."""
        T = int(buf.shape[0])
        k = T if max_sample_num is None else min(int(max_sample_num), T)
        k = min(k, 4096)
        if k == T:
            return median_of_u8_stack(buf)
        step = max(T // k, 1)
        return median_of_u8_stack(buf[0:T:step][:k])

    # ------------------------------------------------------------ TrackNet

    def _windows(self, pre, buf, med, starts) -> torch.Tensor:
        """Forward the windows starting at ``starts``: (B, L, h, w) float32
        probabilities."""
        with record_function("serve::preprocess"):
            x = pre(buf, med, starts)
        with record_function("serve::forward"):
            probs = tracknet_fused_forward(self.params, x)  # (B, h, w, L)
        return probs.permute(0, 3, 1, 2)

    def run_staged(
        self, staged: StagedVideo, img_scaler: Optional[Tuple[float, float]] = None
    ) -> Dict[str, list]:
        """Predict every frame of a staged video: one forward per real window
        chunk, the decoded rows stay on the card until one fetch at the end.
        ``img_scaler`` maps model pixels to source pixels (default from
        ``staged.src_wh``)."""
        T, L, B = staged.T, self.seq_len, self.batch_size
        if img_scaler is None:
            img_scaler = (staged.src_wh[0] / self.w, staged.src_wh[1] / self.h)
        dev = self.device
        med = staged.median
        if med is None:
            med = torch.zeros((self.h, self.w, 3), dtype=torch.float32, device=dev)
        pre = make_staged_preprocessor(self.bg_mode, L, staged.bgr, out_dtype=self.compute_dtype)
        arange_b = torch.arange(B, device=dev)
        rows: List[torch.Tensor] = []
        with torch.inference_mode():
            if self.eval_mode == "nonoverlap":
                n_win = -(-T // L)
                for w0 in range(0, n_win, B):
                    wins = self._windows(pre, staged.buf, med, (w0 + arange_b) * L)
                    with record_function("serve::decode"):
                        dec = decode_heatmaps(wins.reshape(B * L, self.h, self.w))
                    rows.append(_pack(dec)[: min(B, n_win - w0) * L])
                arr = torch.cat(rows).cpu().numpy()[:T]
                return self._rows_to_pred(arr, img_scaler)

            S = max(T - L + 1, 1)  # real windows
            state = ensemble_init(L, (self.h, self.w), dev)
            for w0 in range(0, S, B):
                wins = self._windows(pre, staged.buf, med, w0 + arange_b)
                with record_function("serve::ensemble"):
                    state, frames = ensemble_update_fn(state, wins, self._weights,
                                                       min(S - w0, B))
                with record_function("serve::decode"):
                    rows.append(_pack(decode_heatmaps(frames)))
            with record_function("serve::decode"):
                tail = _pack(decode_heatmaps(ensemble_flush(state)))
            n_rows = len(rows) * B
            full = torch.cat(rows + [tail]).cpu().numpy()  # the one fetch
        arr = np.concatenate([full[:S], full[n_rows : n_rows + (T - S)]], axis=0)[:T]
        return self._rows_to_pred(arr, img_scaler)

    @staticmethod
    def _rows_to_pred(arr: np.ndarray, img_scaler) -> Dict[str, list]:
        """(T, 3) [cx, cy, vis] rows -> the prediction dict."""
        w_s, h_s = img_scaler
        return {
            "Frame": list(range(arr.shape[0])),
            "X": [int(v) for v in (arr[:, 0] * w_s).astype(np.int64)],
            "Y": [int(v) for v in (arr[:, 1] * h_s).astype(np.int64)],
            "Visibility": [int(v) for v in arr[:, 2]],
        }

    # ------------------------------------------------------------ InpaintNet

    @staticmethod
    def _bucket(n: int) -> int:
        """Window counts rounded up to a multiple of 64."""
        return -(-n // 64) * 64

    def inpaint_trajectory(
        self, pred_dict: Dict[str, list], img_shape: Tuple[int, int],
        th_h: Optional[float] = None,
    ) -> Dict[str, list]:
        """InpaintNet pass over a TrackNet trajectory (reference
        predict.py:213-301); ``img_shape`` is the source (width, height)."""
        if self.inpaintnet is None:
            raise ValueError("no InpaintNet checkpoint was given")
        w, h = img_shape
        if th_h is None:
            th_h = h * 0.05
        mask = np.asarray(generate_inpaint_mask(pred_dict, th_h=th_h), np.float32)
        T = len(mask)
        L = self.inpaintnet_seq_len
        x = np.asarray(pred_dict["X"], np.float32) / w
        y = np.asarray(pred_dict["Y"], np.float32) / h
        coords = np.stack([x, y], axis=-1)  # (T, 2) normalised

        nonoverlap = self.eval_mode == "nonoverlap"
        starts = np.arange(0, T, L) if nonoverlap else np.arange(0, max(T - L + 1, 1))
        S = len(starts)
        pad_S = self._bucket(S + L - 1)  # all T frames fit the output
        starts = np.concatenate([starts, np.zeros(pad_S - S, np.int64)])
        idx = np.clip(starts[:, None] + np.arange(L)[None, :], 0, T - 1)
        cw = torch.from_numpy(coords[idx]).to(self.device)  # (pad_S, L, 2)
        mw = torch.from_numpy(mask[idx][..., None]).to(self.device)  # (pad_S, L, 1)

        with torch.inference_mode(), tf32_off():
            out = self.inpaintnet(cw, mw)
            out = out * mw + cw * (1.0 - mw)
            out = zero_below_th(out)
            if nonoverlap:
                flat = out.reshape(-1, 2)[: S * L][:T]
            else:
                weights = torch.from_numpy(get_ensemble_weight(L, self.eval_mode))
                lead = torch.zeros((L - 1,) + tuple(out.shape[1:]), device=self.device)
                ens = ensemble_chunk(torch.cat([lead, out]), weights, 0, S)
                flat = zero_below_th(ens)[:T]
            flat = flat.cpu().numpy()

        # the reference's float32 two-multiply int(c * WIDTH * (w / WIDTH))
        # (predict.py:51): one float64 multiply by w flips some truncations
        cx = (flat[:, 0].astype(np.float32) * np.float32(self.w)
              * np.float32(w / self.w)).astype(np.int64)
        cy = (flat[:, 1].astype(np.float32) * np.float32(self.h)
              * np.float32(h / self.h)).astype(np.int64)
        vis = ((cx != 0) | (cy != 0)).astype(np.int64)
        return {
            "Frame": [int(f) for f in pred_dict["Frame"][:T]],
            "X": cx.tolist(),
            "Y": cy.tolist(),
            "Visibility": vis.tolist(),
        }


def predict_video(
    video_file: str,
    tracknet_file: str,
    inpaintnet_file: str = "",
    eval_mode: str = "weight",
    batch_size: int = 16,
    max_sample_num: int = 1800,
    save_dir: Optional[str] = None,
    video_name: Optional[str] = None,
    input_hw: Optional[Tuple[int, int]] = None,
    device: Optional[Union[str, torch.device]] = None,
    compute_dtype: Optional[torch.dtype] = None,
    conv_backend: Optional[str] = None,
    video_range: Optional[Tuple[int, int]] = None,
    large_video: bool = False,
    output_video: bool = False,
    device_resize: bool = False,
    native_decode: bool = False,
    num_devices: Optional[int] = None,
    stage_format: str = "bgr",
    bucket_quantum: Optional[int] = None,
    program_cache_dir: Optional[str] = None,
) -> Dict[str, list]:
    """The predict CLI's flow (reference predict.py:71-312): decode the
    video with cv2 and resize each frame on the host to model resolution
    (``cv2.INTER_LINEAR``, BGR kept), stage, run TrackNet, InpaintNet where
    a checkpoint is given, and write ``{save_dir}/{name}_ball.csv``.

    As in the JAX package the staged path takes the median over all frames;
    ``max_sample_num`` only bounds the streaming path's median, which is
    not ported. ``conv_backend`` is ``TrackNetPredictor``'s. The options
    after it are the JAX
    package's and raise ``NotImplementedError`` when set.
    """
    _refuse_unported(video_range=video_range, large_video=large_video,
                     output_video=output_video, device_resize=device_resize,
                     native_decode=native_decode, num_devices=(num_devices or 1) > 1,
                     stage_format_yuv420=stage_format == "yuv420",
                     bucket_quantum=bucket_quantum, program_cache_dir=program_cache_dir)
    predictor = TrackNetPredictor(
        tracknet_file, inpaintnet_file or None, eval_mode=eval_mode, batch_size=batch_size,
        compute_dtype=compute_dtype, input_hw=input_hw, device=device,
        conv_backend=conv_backend,
    )
    reader = VideoReader(video_file)
    try:
        w, h = reader.w, reader.h
        if reader.video_len * predictor.h * predictor.w * 3 > 8e9:
            _refuse_unported(streaming_for_videos_past_the_staging_budget=True)
        frames = reader.read_resized_bgr(predictor.w, predictor.h)
    finally:
        reader.release()
    staged = predictor.stage_frames(frames, bgr=True, src_wh=(w, h))
    pred = predictor.run_staged(staged, img_scaler=(w / predictor.w, h / predictor.h))
    if predictor.inpaintnet is not None:
        pred = predictor.inpaint_trajectory(pred, (w, h))
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        name = video_name or os.path.splitext(os.path.basename(video_file))[0]
        write_pred_csv(pred, os.path.join(save_dir, f"{name}_ball.csv"))
    return pred
