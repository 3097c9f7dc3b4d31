"""Serving: frames -> TrackNet -> ensemble -> decode -> InpaintNet -> CSV
(the port of the JAX package's ``inference.py``: ``TrackNetPredictor``,
``predict_video`` and ``predict_videos``).

Three ways a video reaches the card, as in the JAX package:

1. staged (the default): ``upload_video`` decodes the video at model
   resolution, with the native libav reader (``native_video.py``:
   libswscale's scale during decode, DCT-domain lowres on large mpeg4
   sources) where it builds and opens the file, else with cv2 (host
   ``INTER_LINEAR`` resize, BGR kept). With the native reader and even
   model dims (``stage_format`` ``auto`` or ``yuv420``) the frames cross as
   planar YUV420, half the bytes of packed BGR. A producer thread decodes
   slabs of 120 frames into pinned memory while each is copied to the card
   on a side stream; ``finalize_staged`` waits for the copy, converts
   YUV420 to RGB on the card (``yuv420_to_rgb``, slab by slab) and takes
   the exact per-pixel median over all frames (capped at 4096, stride
   T//k); ``run_staged`` then forwards chunks of
   ``batch_size`` windows (window gather + channel stack,
   ``ops/preprocess.py``; the folded-BN TrackNet forward,
   ``models/fused_forward.py``, pool/upsample and conv kernels on the
   card), carries the ensemble's tail across chunks (``ops/ensemble.py``),
   decodes the heatmaps and keeps the packed ``[cx, cy, vis]`` rows on the
   card until one fetch per video. ``nonoverlap`` forwards disjoint
   windows and decodes every frame of each;
2. resident, ``device_resize`` (``predict_frames``): the raw frames go to
   the card once, padded with L-1 copies of the first frame and copies of
   the last (``stage_resident``); each chunk resizes its span with PIL's
   bicubic (``make_window_preprocessor``) and forwards B+L-1 windows with
   the stateless ensemble (``ensemble_chunk``); the median is taken on the
   card over all frames, capped at 1024;
3. streaming, ``large_video`` (``predict_video_streaming``): a producer
   thread reads the chunks' frames (host-resized with cv2 ``INTER_AREA``
   by default, or, for the bg modes without a full-resolution difference,
   scaled during decode by the native reader; raw otherwise) four chunks
   ahead into pinned memory; each
   chunk goes to the card with a non-blocking copy and runs the stateless
   step; the median comes from frames sampled over ``video_range``.

Then ``inpaint_trajectory`` (InpaintNet over windows of the normalised
trajectory, padded to multiples of 64 windows, composited where the mask
says, thresholded at ``COOR_TH``, ensembled, denormalised with the
reference's float32 two-multiply), ``write_pred_csv`` and, on request,
``write_pred_video``. ``predict_videos`` serves many videos in waves
under a staging budget. Every video this module reads is opened through
``open_video`` (cv2) or ``open_native_video`` (the native reader).

With ``num_devices`` above 1 (``run_staged(mesh=)``), each chunk's window
batch is split over a data-parallel mesh (``parallel/mesh.py``): every
entry forwards its share from its own copy of the staged frames, the
median and the folded weights, and the shares come back in window order to
the mesh's first device for the ensemble and the decode.

Serving runs under ``torch.inference_mode()``. The JAX package's TPU
runtime machinery is not ported: bucket padding of the staged buffer and
the AOT program cache raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import queue
import sys
import threading
from typing import (Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
from torch.profiler import record_function

from .config import COOR_TH, HEIGHT, WIDTH
from .device import resolve_device, tf32_off
from .models.fused_forward import fold_batchnorm, fused_params, tracknet_fused_forward
from .native_video import open_native_video
from .ops.detect import decode_heatmaps
from .ops.ensemble import (
    ensemble_chunk,
    ensemble_flush,
    ensemble_init,
    ensemble_update_fn,
    get_ensemble_weight,
)
from .ops.postprocess import generate_inpaint_mask
from .ops.preprocess import (
    gather_windows,
    make_staged_preprocessor,
    make_window_preprocessor,
    median_of_host_frames,
    median_of_u8_stack,
    window_channels,
    yuv420_to_rgb,
)
from .parallel.mesh import (Mesh, canonical_device, check_mesh, device_context, gather_batch,
                            make_mesh, replicate_tree, split_batch, to_device)
from .training.checkpoint import load_model_from_checkpoint
from .utils.io import VideoReader, _require_cv2, write_pred_csv, write_pred_video

# bytes of model-resolution uint8 frames past which a video streams instead
# of staging (the JAX package's device-memory budget)
STAGING_BUDGET_BYTES = 8e9
PREFETCH_CHUNKS = 4  # streaming: chunks read ahead of the card
SLAB_FRAMES = 120  # staging: frames the native reader decodes at once
STAGE_FORMATS = ("auto", "yuv420", "bgr")


def open_video(path: str) -> VideoReader:
    """Open a video for serving. Every read of a video file in this module
    goes through this one name or through ``open_native_video`` (the
    staged path's and the streaming path's native decoder), so a reader of
    frames in memory can stand in for a decoder by replacing them."""
    return VideoReader(path)


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


class UploadedVideo(NamedTuple):
    """The first half of staging: model-resolution frames on their way to
    the card (``upload_staged``, ``upload_video``), before
    ``finalize_staged``."""

    buf: torch.Tensor  # (T, h, w, 3) uint8, or (T, h*w*3//2) YUV420 rows; on the copy stream
    T: int
    bgr: bool
    src_wh: Tuple[int, int]
    ready: Optional[torch.cuda.Event]  # recorded after the copy (None on the CPU)
    host: Tuple[torch.Tensor, ...]  # the pinned sources, kept until the copy is waited on
    yuv: bool = False  # buf holds planar YUV420 rows, converted in finalize_staged


def _refuse_unported(**options) -> None:
    """Raise ``NotImplementedError`` naming each option that is set."""
    bad = [k for k, v in options.items() if v]
    if bad:
        raise NotImplementedError(f"not ported to PyTorch yet: {', '.join(bad)}")


def _pack(dec: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([dec["cx"], dec["cy"], dec["vis"]], dim=-1).to(torch.int32)


def _prefetched(items: Iterator, what: Optional[str], depth: int = PREFETCH_CHUNKS,
                stop: Optional[threading.Event] = None) -> Iterator:
    """Yield ``items`` as a producer thread makes them, at most ``depth``
    ahead. An error of the producer is raised after the items it made: as
    ``RuntimeError(what)`` where ``what`` is given (a swallowed one would
    silently truncate the prediction CSV), else as it was. Leaving the loop
    early sets ``stop``, which ``items`` may poll where it waits, and joins
    the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    err: List[BaseException] = []
    stop = stop if stop is not None else threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for item in items:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            err.append(e)
        finally:
            put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            yield item
    finally:
        stop.set()
        thread.join()
    if err:
        if what is None:
            raise err[0]
        raise RuntimeError(what) from err[0]


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

    ``native_decode`` lets the staged and streaming paths decode with the
    native libav reader where it builds and opens the video (else cv2).
    ``stage_format``: ``"yuv420"`` stages planar YUV420 (half the bytes of
    packed BGR; converted to RGB on the card), ``"bgr"`` packed BGR, and
    ``"auto"`` YUV420 wherever the native reader serves the video and the
    model dims are even, else BGR. ``decode_backend`` says what the last
    staging or stream decoded with: ``"cv2"``, ``"native-lowres{n}"``, with
    ``"+yuv420"`` where it staged YUV420.
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
        native_decode: bool = True,
        stage_format: str = "auto",
    ):
        if eval_mode not in ("nonoverlap", "average", "weight"):
            raise ValueError(f"Invalid eval_mode: {eval_mode!r}")
        if stage_format not in STAGE_FORMATS:
            raise ValueError(f"stage_format must be auto|yuv420|bgr: {stage_format}")
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
        self.native_decode = bool(native_decode)
        self.stage_format = stage_format
        self.decode_backend = "unused"
        weights = get_ensemble_weight(
            self.seq_len, eval_mode if eval_mode != "nonoverlap" else "average"
        )
        self._weights = torch.from_numpy(weights).to(self.device)
        self._preproc = make_window_preprocessor(self.bg_mode, self.seq_len, (self.h, self.w))
        # staging copies run here, beside the chunks on the default stream
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        self._params_by_device: Dict[torch.device, Dict] = {}  # run_staged(mesh=)
        self.inpaintnet = None
        if inpaintnet_file:
            model, in_pd = load_model_from_checkpoint(inpaintnet_file)
            self.inpaintnet = model.to(self.device).eval()
            self.inpaintnet_seq_len = int(in_pd.get("seq_len", 16))

    # ------------------------------------------------------------ staging

    def _upload_parts(self, parts: Iterable[torch.Tensor], bgr: bool, yuv: bool,
                      src_wh: Tuple[int, int]) -> UploadedVideo:
        """Copy host tensors of frames (pinned when serving on the card) to
        the card as they come, each with a non-blocking copy on the
        predictor's copy stream, then join them there into one buffer and
        record an event after it."""
        on_card = self._copy_stream is not None
        host, bufs, ready = [], [], None
        with torch.cuda.stream(self._copy_stream) if on_card else contextlib.nullcontext():
            for part in parts:
                host.append(part)
                bufs.append(part.to(self.device, non_blocking=True))
            if not bufs:
                raise ValueError("no frames to stage: the video yielded zero frames")
            buf = bufs[0] if len(bufs) == 1 else torch.cat(bufs)
            if on_card:
                ready = torch.cuda.Event()
                ready.record()
        return UploadedVideo(buf, int(buf.shape[0]), bgr, src_wh, ready, tuple(host), yuv)

    def upload_staged(
        self, frames_u8: np.ndarray, bgr: bool = False, src_wh: Optional[Tuple[int, int]] = None,
        yuv: bool = False,
    ) -> UploadedVideo:
        """Start staging (T, h, w, 3) uint8 frames already at model
        resolution, or with ``yuv`` (T, h*w*3//2) planar YUV420 rows:
        pinned, then one non-blocking copy on the predictor's copy stream,
        with an event recorded after it. ``src_wh`` is the source video's
        (width, height), the model resolution by default. Safe from a
        producer thread (``predict_videos``)."""
        frames_u8 = np.ascontiguousarray(frames_u8)
        shape = (self.h * self.w * 3 // 2,) if yuv else (self.h, self.w, 3)
        if frames_u8.dtype != np.uint8 or frames_u8.shape[1:] != shape:
            raise ValueError(f"need (T, {', '.join(map(str, shape))}) uint8 frames, got "
                             f"{frames_u8.dtype} {frames_u8.shape}")
        if frames_u8.shape[0] == 0:
            raise ValueError("no frames to stage: the video yielded zero frames")
        host = torch.from_numpy(frames_u8)
        if self._copy_stream is not None:
            host = host.pin_memory()
        return self._upload_parts([host], bgr and not yuv, yuv, src_wh or (self.w, self.h))

    def finalize_staged(self, up: UploadedVideo,
                        max_sample_num: Optional[int] = None) -> StagedVideo:
        """Finish staging on the current stream: wait for the copy, convert
        YUV420 rows to RGB (``yuv420_to_rgb``, slab by slab, into a new
        buffer; the staged video is then ``bgr=False``), then the median
        background (``bg_mode`` needs one). ``up.yuv`` must say what
        ``up.buf`` holds (the JAX package's layout contract): a flag that
        does not match raises ``ValueError``."""
        buf = up.buf
        if up.yuv != (buf.dim() == 2):
            raise ValueError(f"yuv={up.yuv} does not match the staged layout (ndim="
                             f"{buf.dim()}): pass the UploadedVideo the upload returned")
        if up.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(up.ready)
            buf.record_stream(stream)  # allocated on the copy stream, read on this one
        bgr = up.bgr
        if up.yuv:
            with record_function("serve::yuv420_to_rgb"):
                buf = yuv420_to_rgb(buf, self.h, self.w)
            bgr = False
        median = self._median_staged(buf, max_sample_num) if self.bg_mode else None
        return StagedVideo(buf, up.T, median, bgr, up.src_wh)

    def stage_frames(
        self,
        frames_u8: np.ndarray,
        bgr: bool = False,
        src_wh: Optional[Tuple[int, int]] = None,
        max_sample_num: Optional[int] = None,
    ) -> StagedVideo:
        """Stage (T, h, w, 3) uint8 frames already at model resolution
        (the JAX package's ``stage_frames_host`` / ``finalize_staged``):
        ``upload_staged``, then ``finalize_staged``."""
        return self.finalize_staged(self.upload_staged(frames_u8, bgr, src_wh), max_sample_num)

    def upload_video(self, video_file: str, slab_frames: int = SLAB_FRAMES) -> UploadedVideo:
        """Decode a video at model resolution and start its upload: the
        first half of the JAX package's ``stage_video``
        (``upload_video_slabs``), with its choice of decoder.

        With ``native_decode`` the native reader (``open_native_video``,
        ``lowres=-1``) decodes slabs of ``slab_frames`` frames in a producer
        thread (the foreign call releases the GIL) into pinned memory,
        planar YUV420 where ``stage_format`` allows it and the model dims
        are even, else packed BGR; each slab is copied to the card as it
        comes. A decode error raises ``RuntimeError`` (no truncated video).
        A forced ``"yuv420"`` that cannot be honoured raises
        ``RuntimeError``; only ``"auto"`` falls back, to packed BGR and,
        where the native reader does not open the file, to cv2 (host
        ``INTER_LINEAR`` resize, BGR kept). The source (width, height)
        comes from the decoder, at full resolution under lowres."""
        H, W = self.h, self.w
        reader = open_native_video(video_file, W, H, lowres=-1, bgr=True) \
            if self.native_decode else None
        use_yuv = (reader is not None and self.stage_format in ("auto", "yuv420")
                   and H % 2 == 0 and W % 2 == 0)
        if self.stage_format == "yuv420" and not use_yuv:
            # a forced format must not quietly become packed BGR (it would void
            # an A/B staging measurement): only "auto" falls back
            reason = ("the native decoder is unavailable for this video" if reader is None
                      else f"model dims {H}x{W} are not even")
            if reader is not None:
                reader.close()
            raise RuntimeError(f"stage_format='yuv420' cannot be honored: {reason}; use "
                               "stage_format='auto' to allow packed-BGR fallback")
        if reader is None:
            self.decode_backend = "cv2"
            cv = open_video(video_file)
            try:
                src_wh = (cv.w, cv.h)
                frames = cv.read_resized_bgr(W, H)
            finally:
                cv.release()
            return self.upload_staged(frames, bgr=True, src_wh=src_wh)

        self.decode_backend = f"native-lowres{reader.applied_lowres}" + (
            "+yuv420" if use_yuv else "")
        shape = (H * W * 3 // 2,) if use_yuv else (H, W, 3)
        read = reader.read_into_yuv if use_yuv else reader.read_into
        pin = self._copy_stream is not None

        def slabs() -> Iterator[torch.Tensor]:
            while True:
                host = torch.empty((slab_frames,) + shape, dtype=torch.uint8, pin_memory=pin)
                n = read(host.numpy())
                if n <= 0:
                    return
                yield host[:n]

        try:
            with contextlib.closing(_prefetched(
                    slabs(), f"video decode failed mid-stream: {video_file}",
                    depth=2)) as parts:
                return self._upload_parts(parts, not use_yuv, use_yuv,
                                          (reader.src_w, reader.src_h))
        finally:
            reader.close()

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

    def _forward(self, x: torch.Tensor, params: Optional[Dict] = None) -> torch.Tensor:
        """(B, h, w, C_in) model input -> (B, L, h, w) float32 probabilities;
        ``params`` are the folded weights on x's device (the predictor's)."""
        with record_function("serve::forward"):
            probs = tracknet_fused_forward(self.params if params is None else params, x)
        return probs.permute(0, 3, 1, 2)

    def _windows(self, pre, buf, med, starts, params: Optional[Dict] = None) -> torch.Tensor:
        """Forward the windows of staged frames starting at ``starts``."""
        with record_function("serve::preprocess"):
            x = pre(buf, med, starts)
        return self._forward(x, params)

    def _params_on(self, device: torch.device) -> Dict:
        """The folded weights on ``device``, copied there once per predictor."""
        key = canonical_device(device)
        if key == canonical_device(self.device):
            return self.params
        if key not in self._params_by_device:
            self._params_by_device[key] = to_device(self.params, key)
        return self._params_by_device[key]

    def _sharded_windows(self, pre, buf, med, mesh: Mesh) -> Callable:
        """``forward(starts)`` -> (B, L, h, w) probabilities of the windows at
        ``starts``, each of the mesh's equal shares forwarded on its entry's
        device from that device's copy of the staged frames and the median
        (made here, once per video) and of the folded weights; the shares
        are gathered in window order on the mesh's first device."""
        replicas = replicate_tree((buf, med), mesh)
        params = [self._params_on(dev) for dev in mesh.devices]

        def forward(starts: torch.Tensor) -> torch.Tensor:
            shares = []
            for dev, (b, m), p, s in zip(mesh.devices, replicas, params,
                                         split_batch(starts, mesh.size)):
                with device_context(dev):
                    shares.append(self._windows(pre, b, m, s.to(dev), p))
            with record_function("serve::gather"):
                return gather_batch(shares, mesh)

        return forward

    def _forward_windows(self, frames_u8, median, starts) -> torch.Tensor:
        """Forward the windows of raw frames (at source resolution)
        starting at ``starts``: each frame resized once on the card."""
        with record_function("serve::preprocess"):
            x = self._preproc(frames_u8, median, starts)
        return self._forward(x)

    def _preresized_windows(self, rgb, diff, median_resized, starts) -> torch.Tensor:
        """Forward the windows of host-resized uint8 frames (and background
        differences) starting at ``starts``."""
        L = self.seq_len
        with record_function("serve::preprocess"):
            rgb_w = gather_windows(rgb.to(torch.float32), starts, L) if rgb is not None else None
            diff_w = (gather_windows(diff.to(torch.float32), starts, L)
                      if diff is not None else None)
            med = median_resized.to(torch.float32) if median_resized is not None else None
            x = window_channels(rgb_w, diff_w, med, self.bg_mode)
        return self._forward(x)

    def _ensemble_decode(self, wins: torch.Tensor, t0: int, num_windows: int) -> torch.Tensor:
        """Stateless ensemble of B+L-1 windows, then decode: packed (B, 3)
        rows of frames t0 .. t0+B-1."""
        with record_function("serve::ensemble"):
            frames = ensemble_chunk(wins, self._weights, t0, num_windows)
        with record_function("serve::decode"):
            return _pack(decode_heatmaps(frames))

    def _decode_all(self, wins: torch.Tensor) -> torch.Tensor:
        """Decode every frame of disjoint windows: packed (B*L, 3) rows."""
        with record_function("serve::decode"):
            return _pack(decode_heatmaps(wins.reshape((-1,) + tuple(wins.shape[2:]))))

    def _arange(self, n: int) -> torch.Tensor:
        return torch.arange(n, device=self.device)

    def _overlap_step(self, frames_u8, median, t0: int, num_windows: int) -> torch.Tensor:
        """Stateless chunk (JAX ``_overlap_step_impl``): raw frames of
        global frames [t0-L+1, t0+B+L-1) (clipped at the video's bounds);
        forwards the B+L-1 windows, ensembles and decodes frames t0 ..
        t0+B-1."""
        nwin = frames_u8.shape[0] - (self.seq_len - 1)
        return self._ensemble_decode(
            self._forward_windows(frames_u8, median, self._arange(nwin)), t0, num_windows)

    def _nonoverlap_step(self, frames_u8, median) -> torch.Tensor:
        """Disjoint windows of B*L raw frames (JAX ``_nonoverlap_step_impl``)."""
        L = self.seq_len
        n_win = frames_u8.shape[0] // L
        return self._decode_all(self._forward_windows(frames_u8, median, self._arange(n_win) * L))

    def _overlap_step_preresized(self, rgb, diff, median_resized, t0: int,
                                 num_windows: int) -> torch.Tensor:
        """``_overlap_step`` on host-resized frames (JAX
        ``_overlap_step_preresized_impl``)."""
        nwin = (rgb if rgb is not None else diff).shape[0] - (self.seq_len - 1)
        return self._ensemble_decode(
            self._preresized_windows(rgb, diff, median_resized, self._arange(nwin)),
            t0, num_windows)

    def _nonoverlap_step_preresized(self, rgb, diff, median_resized) -> torch.Tensor:
        """``_nonoverlap_step`` on host-resized frames (JAX
        ``_nonoverlap_step_preresized_impl``)."""
        L = self.seq_len
        n_win = (rgb if rgb is not None else diff).shape[0] // L
        return self._decode_all(
            self._preresized_windows(rgb, diff, median_resized, self._arange(n_win) * L))

    def _overlap_step_resident(self, all_frames, median, t0: int,
                               num_windows: int) -> torch.Tensor:
        """The overlap chunk of output frames t0 .. t0+B-1 against the
        resident padded buffer: its span starts at padded index t0."""
        L, B = self.seq_len, self.batch_size
        return self._overlap_step(all_frames[t0 : t0 + B + 2 * L - 2], median, t0, num_windows)

    def _nonoverlap_step_resident(self, all_frames, median, w0: int,
                                  num_frames: int) -> torch.Tensor:
        """Windows w0 .. w0+B-1 against the resident buffer, their start
        frames clipped into the video (the reference's repeat-last-frame
        padding). Only the chunk's B*L+L-1-frame span is resized; rows
        past the buffer's end read its last row, a copy of the last frame."""
        L, B = self.seq_len, self.batch_size
        base = min(w0 * L, max(num_frames - 1, 0)) + (L - 1)
        starts = ((w0 + self._arange(B)) * L).clamp_(0, max(num_frames - 1, 0)) + (L - 1 - base)
        idx = (base + self._arange(B * L + L - 1)).clamp_(max=all_frames.shape[0] - 1)
        return self._decode_all(self._forward_windows(all_frames[idx], median, starts))

    def run_staged(
        self, staged: StagedVideo, img_scaler: Optional[Tuple[float, float]] = None,
        mesh: Optional[Mesh] = None,
    ) -> Dict[str, list]:
        """Predict every frame of a staged video: one forward per real window
        chunk, the decoded rows stay on the card until one fetch at the end.
        ``img_scaler`` maps model pixels to source pixels (default from
        ``staged.src_wh``). With ``mesh`` (``parallel.mesh.check_mesh``:
        its size divides ``batch_size``, its first device is the
        predictor's) each chunk's windows are forwarded in equal shares over
        its entries (``_sharded_windows``); the rows are the single-device
        run's."""
        T, L, B = staged.T, self.seq_len, self.batch_size
        if mesh is not None:
            check_mesh(mesh, B, self.device, "predictor")
        if img_scaler is None:
            img_scaler = (staged.src_wh[0] / self.w, staged.src_wh[1] / self.h)
        dev = self.device
        med = staged.median
        if med is None:
            med = torch.zeros((self.h, self.w, 3), dtype=torch.float32, device=dev)
        pre = make_staged_preprocessor(self.bg_mode, L, staged.bgr, out_dtype=self.compute_dtype)
        arange_b = self._arange(B)
        rows: List[torch.Tensor] = []
        with torch.inference_mode():
            if mesh is None:
                forward = functools.partial(self._windows, pre, staged.buf, med)
            else:
                forward = self._sharded_windows(pre, staged.buf, med, mesh)
            if self.eval_mode == "nonoverlap":
                n_win = -(-T // L)
                for w0 in range(0, n_win, B):
                    wins = forward((w0 + arange_b) * L)
                    rows.append(self._decode_all(wins)[: min(B, n_win - w0) * L])
                arr = torch.cat(rows).cpu().numpy()[:T]
                return self._rows_to_pred(arr, img_scaler)

            S = max(T - L + 1, 1)  # real windows
            state = ensemble_init(L, (self.h, self.w), dev)
            for w0 in range(0, S, B):
                wins = forward(w0 + arange_b)
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

    def _collect_packed(self, results: Sequence[Tuple[torch.Tensor, int]], total_frames: int,
                        img_scaler) -> Dict[str, list]:
        """Each chunk's first ``n_valid`` packed rows, in order, fetched in
        one copy; at most ``total_frames`` of them."""
        if not results:
            return self._rows_to_pred(np.zeros((0, 3), np.int32), img_scaler)
        rows = torch.cat([packed[:n_valid] for packed, n_valid in results])
        return self._rows_to_pred(rows.cpu().numpy()[:total_frames], img_scaler)

    # ---------------------------------------- resident raw frames (device resize)

    def stage_resident(self, frames: np.ndarray) -> Tuple[torch.Tensor, int]:
        """Put a whole raw video (T, H0, W0, 3) uint8 on the card once,
        padded for the chunks: L-1 copies of frame 0, the frames, then
        copies of the last frame up to the last overlap chunk's span. One
        non-blocking copy from pinned memory into the middle of the buffer
        (the JAX package's ``upload_frames`` + ``build_resident``, there
        called ``stage_frames``; without its 256-frame bucket). Returns the
        buffer and T."""
        frames = np.ascontiguousarray(frames)
        if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"need (T, H, W, 3) uint8 frames, got {frames.dtype} {frames.shape}")
        T = int(frames.shape[0])
        if T == 0:
            raise ValueError("no frames to stage: the video yielded zero frames")
        L, B = self.seq_len, self.batch_size
        total = (L - 1) + -(-T // B) * B + (L - 1)
        buf = torch.empty((total,) + frames.shape[1:], dtype=torch.uint8, device=self.device)
        host = torch.from_numpy(frames)
        if self.device.type == "cuda":
            host = host.pin_memory()
        buf[L - 1 : L - 1 + T].copy_(host, non_blocking=True)
        buf[: L - 1] = buf[L - 1]
        buf[L - 1 + T :] = buf[L - 2 + T]
        return buf, T

    def median_of_resident(self, all_frames: torch.Tensor, T: int,
                           max_sample_num: Optional[int] = None) -> torch.Tensor:
        """Median background of the resident buffer's frames, on the card:
        all of them by default (the reference's in-memory path), capped at
        1024 frames at a stride of T // k. (H0, W0, 3) float32."""
        L = self.seq_len
        k = T if max_sample_num is None else min(int(max_sample_num), T)
        k = min(k, 1024)
        step = max(T // k, 1)
        idx = torch.arange(L - 1, L - 1 + T, step, device=all_frames.device)[:k]
        return median_of_u8_stack(all_frames[idx])

    def run_resident(self, all_frames: torch.Tensor, T: int, median=None,
                     img_scaler: Tuple[float, float] = (1.0, 1.0)) -> Dict[str, list]:
        """Every chunk against a resident buffer (both eval modes); the
        packed rows stay on the card until one fetch."""
        L, B = self.seq_len, self.batch_size
        med = (torch.as_tensor(median, dtype=torch.float32).to(self.device)
               if median is not None else None)
        results = []
        with torch.inference_mode():
            if self.eval_mode == "nonoverlap":
                n_win = -(-T // L)
                for w0 in range(0, n_win, B):
                    packed = self._nonoverlap_step_resident(all_frames, med, w0, T)
                    results.append((packed, min(B, n_win - w0) * L))
            else:
                S = max(T - L + 1, 1)
                for t0 in range(0, T, B):
                    packed = self._overlap_step_resident(all_frames, med, t0, S)
                    results.append((packed, min(B, T - t0)))
            return self._collect_packed(results, T, img_scaler)

    def predict_frames(
        self,
        frames: np.ndarray,
        median: Optional[np.ndarray] = None,
        img_scaler: Tuple[float, float] = (1.0, 1.0),
        max_sample_num: Optional[int] = None,
    ) -> Dict[str, list]:
        """TrackNet over in-memory raw RGB uint8 frames (T, H0, W0, 3),
        resized on the card with PIL's bicubic: ``stage_resident``, the
        median on the card where ``bg_mode`` needs one and none is given,
        then ``run_resident``."""
        all_frames, T = self.stage_resident(frames)
        if median is None and self.bg_mode:
            median = self.median_of_resident(all_frames, T, max_sample_num)
        return self.run_resident(all_frames, T, median, img_scaler)

    # ------------------------------------------------------------ streaming

    def _host_stack(self, frames: Sequence[np.ndarray]) -> torch.Tensor:
        """Stack frames in one copy, into pinned memory when serving on the
        card (the producer thread does this, ahead of the chunk)."""
        out = torch.empty((len(frames),) + frames[0].shape, dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        dst = out.numpy()
        for j, f in enumerate(frames):
            dst[j] = f
        return out

    def _window_chunks(self, read: Callable[[], object], T: int) -> Iterator:
        """Read items (frames) in order and yield each chunk's as
        ``(items, t0, n_valid)``. ``nonoverlap``: B*L items (the last chunk
        padded by repeats of its last item), ``t0`` None. Overlap: global
        frames [t0-L+1, t0+B+L-1) clipped into the video. Stops gracefully
        where the container counted more frames than decode."""
        L, B = self.seq_len, self.batch_size
        buf: list = []
        if self.eval_mode == "nonoverlap":
            total = -(-T // L) * L
            emitted = 0
            while emitted < total:
                while len(buf) < B * L:
                    item = read()
                    if item is None:
                        break
                    buf.append(item)
                if not buf:
                    break
                valid = min(len(buf), total - emitted)
                chunk = buf[: B * L]
                yield chunk + [chunk[-1]] * (B * L - len(chunk)), None, valid
                emitted += B * L
                buf = buf[B * L :]
            return
        base = 0  # global index of buf[0]
        for t0 in range(0, T, B):
            hi = min(t0 + B + L - 1, T)
            while base + len(buf) < hi:
                item = read()
                if item is None:
                    break
                buf.append(item)
            lo = max(t0 - L + 1, 0)
            if lo > base:  # drop frames before t0-L+1
                buf = buf[lo - base :]
                base = lo
            if not buf:
                break
            idx = np.clip(np.arange(t0 - L + 1, t0 + B + L - 1) - base, 0, len(buf) - 1)
            yield [buf[i] for i in idx], t0, min(B, T - t0)

    def _run_pipeline(self, chunks: Iterator, total_frames: int, img_scaler, step,
                      what: str) -> Dict[str, list]:
        """Drive ``step(*tensors, t0)`` over chunks of host tensors that a
        producer thread makes ``PREFETCH_CHUNKS`` ahead; each tensor goes to
        the card with a non-blocking copy; the rows are fetched once."""
        results = []
        with torch.inference_mode(), contextlib.closing(_prefetched(chunks, what)) as items:
            for *host, t0, n_valid in items:
                dev = [t.to(self.device, non_blocking=True) if t is not None else None
                       for t in host]
                results.append((step(*dev, t0), n_valid))
            return self._collect_packed(results, total_frames, img_scaler)

    def predict_video_streaming(
        self,
        video_file: str,
        max_sample_num: int = 1800,
        video_range: Optional[Tuple[int, int]] = None,
        median: Optional[np.ndarray] = None,
        host_resize: bool = True,
    ) -> Dict[str, list]:
        """TrackNet over a video streamed from its file in bounded memory
        (``--large_video``). The median background (``bg_mode`` needs one)
        comes from at most ``max_sample_num`` frames sampled over
        ``video_range`` seconds (``VideoReader.sample_frames``), taken on
        the card one slab of rows at a time (``median_of_host_frames``), so
        that its device memory does not grow with ``max_sample_num``. With
        ``host_resize`` the frames are resized on the host
        (``_streaming_host_resize``, cv2); without, raw frames go to the
        card and are resized there (``_overlap_step`` /
        ``_nonoverlap_step``). A decode error raises ``RuntimeError``."""
        reader = open_video(video_file)
        try:
            img_scaler = (reader.w / self.w, reader.h / self.h)
            if median is None and self.bg_mode:
                median = median_of_host_frames(reader.sample_frames(max_sample_num, video_range),
                                               self.device)
            if host_resize:
                return self._streaming_host_resize(reader, median, img_scaler)
            T = reader.video_len

            def chunks():
                reader.seek(0)
                for frames, t0, n_valid in self._window_chunks(reader.read, T):
                    yield self._host_stack(frames), t0, n_valid

            med = (torch.as_tensor(median, dtype=torch.float32).to(self.device)
                   if median is not None else None)
            S = max(T - self.seq_len + 1, 1)
            if self.eval_mode == "nonoverlap":
                step = lambda frames, t0: self._nonoverlap_step(frames, med)  # noqa: E731
            else:
                step = lambda frames, t0: self._overlap_step(frames, med, t0, S)  # noqa: E731
            return self._run_pipeline(chunks(), T, img_scaler, step,
                                      f"video decode failed mid-stream: {video_file}")
        finally:
            reader.release()

    def _streaming_host_resize(self, reader, median, img_scaler) -> Dict[str, list]:
        """Streaming with the resize on the host: each frame resized with
        cv2 ``INTER_AREA`` (and, for the subtract modes, the mod-256
        background difference taken at source resolution and resized), the
        median resized from ``median.astype(uint8)``: the JAX package's
        cv2 recipe. Only 288x512 uint8 frames cross to the card. For the bg
        modes without a full-resolution difference (``''``, ``concat``) and
        with ``native_decode``, the native reader (``lowres=-1``) decodes
        RGB straight at model resolution in batches of 64 where it opens
        the file, and the cv2 reader is released (JAX's native branch)."""
        cv2 = _require_cv2()
        T = reader.video_len
        H, W = self.h, self.w
        need_diff = self.bg_mode in ("subtract", "subtract_concat")
        need_rgb = self.bg_mode in ("", "subtract_concat", "concat")
        native = (open_native_video(reader.path, W, H, lowres=-1, bgr=False)
                  if self.native_decode and not need_diff else None)
        if native is not None:
            self.decode_backend = f"native-lowres{native.applied_lowres}"
            reader.release()
        else:
            self.decode_backend = "cv2"
        med_resized = None
        if self.bg_mode == "concat":
            med_resized = torch.from_numpy(cv2.resize(
                median.astype(np.uint8), (W, H), interpolation=cv2.INTER_AREA)).to(self.device)

        def read_processed():
            frame = reader.read()
            if frame is None:
                return None
            rgb = cv2.resize(frame, (W, H), interpolation=cv2.INTER_AREA) if need_rgb else None
            diff = None
            if need_diff:
                d = np.sum(np.abs(frame - median), axis=2).astype("uint8")
                diff = cv2.resize(d, (W, H), interpolation=cv2.INTER_AREA)[..., None]
            return rgb, diff

        def native_frames() -> Iterator[Tuple[np.ndarray, None]]:
            while True:
                batch = native.read_batch(64)  # model-resolution RGB; releases the GIL
                if batch is None:
                    return
                for f in batch:
                    yield f, None

        def chunks():
            if native is None:
                reader.seek(0)
                read = read_processed
            else:
                read = functools.partial(next, native_frames(), None)
            for items, t0, n_valid in self._window_chunks(read, T):
                rgb = self._host_stack([i[0] for i in items]) if need_rgb else None
                diff = self._host_stack([i[1] for i in items]) if need_diff else None
                yield rgb, diff, t0, n_valid

        S = max(T - self.seq_len + 1, 1)
        if self.eval_mode == "nonoverlap":
            step = lambda rgb, diff, t0: self._nonoverlap_step_preresized(  # noqa: E731
                rgb, diff, med_resized)
        else:
            step = lambda rgb, diff, t0: self._overlap_step_preresized(  # noqa: E731
                rgb, diff, med_resized, t0, S)
        try:
            return self._run_pipeline(chunks(), T, img_scaler, step,
                                      f"video decode failed mid-stream: {reader.path}")
        finally:
            if native is not None:
                native.close()

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


def _finish(predictor: TrackNetPredictor, video_file: str, pred: Dict[str, list],
            src_wh: Tuple[int, int], save_dir: Optional[str], name: Optional[str],
            output_video: bool, traj_len: int) -> Dict[str, list]:
    """InpaintNet where a checkpoint is given, then ``{save_dir}/{name}_ball.csv``
    and, with ``output_video``, ``{save_dir}/{name}.mp4``."""
    if predictor.inpaintnet is not None:
        pred = predictor.inpaint_trajectory(pred, src_wh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        name = name or os.path.splitext(os.path.basename(video_file))[0]
        write_pred_csv(pred, os.path.join(save_dir, f"{name}_ball.csv"))
        if output_video:
            write_pred_video(video_file, pred, os.path.join(save_dir, f"{name}.mp4"),
                             traj_len=traj_len)
    return pred


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
    traj_len: int = 8,
    device_resize: bool = False,
    native_decode: bool = True,
    num_devices: Optional[int] = None,
    stage_format: str = "auto",
    bucket_quantum: Optional[int] = None,
    program_cache_dir: Optional[str] = None,
) -> Dict[str, list]:
    """The predict CLI's flow (reference predict.py:71-312): TrackNet,
    InpaintNet where a checkpoint is given, ``{save_dir}/{name}_ball.csv``
    and, with ``output_video``, the overlay ``{name}.mp4`` (comets of
    ``traj_len`` frames; cv2).

    The frames reach the card one of three ways (the module docstring):
    staged (the default, median over all frames), decoded at model
    resolution by the native libav reader where ``native_decode`` and the
    library allow it, in planar YUV420 as ``stage_format`` allows
    (``TrackNetPredictor``), else by cv2 with a host ``INTER_LINEAR``
    resize; ``device_resize``: raw frames (cv2) resized on the card with
    PIL's bicubic (``predict_frames``, median over all frames, capped at
    1024); ``large_video``: streamed with host ``INTER_AREA`` resize
    (``predict_video_streaming``), its median over at most
    ``max_sample_num`` frames of ``video_range`` (start, end) seconds,
    which only this path reads. A video whose model-resolution frames pass
    ``STAGING_BUDGET_BYTES`` streams too unless ``device_resize`` is set.
    ``num_devices`` > 1 shards the staged path's window batches over a
    mesh of that many entries of ``device``'s type (``make_mesh``); it
    refuses ``large_video`` and ``device_resize``, and a video that streams
    for its size is served on one device with a warning.
    ``bucket_quantum`` and ``program_cache_dir`` are the JAX package's and
    raise ``NotImplementedError``.
    """
    _refuse_unported(bucket_quantum=bucket_quantum, program_cache_dir=program_cache_dir)
    mesh = None
    if (num_devices or 0) > 1:
        if large_video or device_resize:
            raise ValueError("num_devices > 1 is only supported on the default staged path; "
                             "drop --large_video/--device_resize or num_devices")
        mesh = make_mesh(num_devices, device=resolve_device(device).type)
    predictor = TrackNetPredictor(
        tracknet_file, inpaintnet_file or None, eval_mode=eval_mode, batch_size=batch_size,
        compute_dtype=compute_dtype, input_hw=input_hw, device=device, conv_backend=conv_backend,
        native_decode=native_decode, stage_format=stage_format,
    )
    reader = open_video(video_file)
    try:
        w, h = reader.w, reader.h
        oversized = reader.video_len * predictor.h * predictor.w * 3 > STAGING_BUDGET_BYTES
        frames = reader.read_all() if device_resize and not large_video else None
    finally:
        reader.release()
    img_scaler = (w / predictor.w, h / predictor.h)
    if frames is not None:
        pred = predictor.predict_frames(frames, img_scaler=img_scaler)
    elif large_video or oversized:
        if mesh is not None:
            print("warning: video exceeds the staging budget; falling back to single-device "
                  "streaming (num_devices ignored)", file=sys.stderr)
        pred = predictor.predict_video_streaming(video_file, max_sample_num=max_sample_num,
                                                 video_range=video_range)
    else:
        staged = predictor.finalize_staged(predictor.upload_video(video_file))
        pred = predictor.run_staged(staged, img_scaler=img_scaler, mesh=mesh)
    return _finish(predictor, video_file, pred, (w, h), save_dir, video_name, output_video,
                   traj_len)


def predict_videos(
    video_files: Sequence[str],
    tracknet_file: str,
    inpaintnet_file: str = "",
    eval_mode: str = "weight",
    batch_size: int = 16,
    max_sample_num: int = 1800,
    save_dir: Optional[str] = None,
    output_video: bool = False,
    traj_len: int = 8,
    staging_budget_bytes: float = STAGING_BUDGET_BYTES,
    input_hw: Optional[Tuple[int, int]] = None,
    on_error: str = "raise",
    predictor: Optional[TrackNetPredictor] = None,
    stats: Optional[dict] = None,
    device: Optional[Union[str, torch.device]] = None,
    compute_dtype: Optional[torch.dtype] = None,
    conv_backend: Optional[str] = None,
    native_decode: bool = True,
    num_devices: Optional[int] = None,
    stage_format: str = "auto",
    bucket_quantum: Optional[int] = None,
    program_cache_dir: Optional[str] = None,
) -> Dict[str, Dict[str, list]]:
    """Serve many videos with one model load (the JAX package's
    ``predict_videos``): returns {video path: prediction dict}; with
    ``save_dir`` each video also writes ``{name}_ball.csv`` (and, with
    ``output_video``, ``{name}.mp4``).

    Videos are staged in waves. A producer thread reads each video and
    starts its upload (``upload_video``: the native reader or cv2, YUV420
    or BGR as ``native_decode`` and ``stage_format`` say; pinned memory, the
    copy stream, an event) while the caller's thread finalizes and serves
    the wave before. A semaphore keeps at most two waves on the card, so a
    wave holds half of ``staging_budget_bytes``; a video over half the
    budget runs alone in a wave that holds both slots, and one over the
    whole budget streams (``predict_video_streaming``, host resize) after
    the waves. The port has no bucket padding: a video's bytes are its
    ``T * h * w * 3`` model-resolution frames (the JAX rule, whatever the
    staging format), and ``stats["waves"][i]["buckets"]`` holds real frame
    counts.

    ``on_error="skip"`` reports a failing video to stderr and drops it
    (one corrupt file must not stop the rest); ``"raise"``, the default,
    propagates. ``predictor`` reuses a ``TrackNetPredictor`` (the model and
    eval arguments are then ignored). ``stats``, a dict, receives
    ``"waves"`` (``{"videos", "slots", "buckets"}`` in compute order) and
    ``"streaming"`` (the files that streamed). ``num_devices`` > 1 shards
    every staged video's window batches over one mesh (``make_mesh``, of
    the predictor's device type); the videos that stream are served on one
    device, with a warning. ``bucket_quantum`` and ``program_cache_dir``
    raise ``NotImplementedError``.
    """
    _refuse_unported(bucket_quantum=bucket_quantum, program_cache_dir=program_cache_dir)
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
    mesh = None
    if (num_devices or 0) > 1:
        kind = (predictor.device if predictor is not None else resolve_device(device)).type
        mesh = make_mesh(num_devices, device=kind)
    if predictor is None:
        predictor = TrackNetPredictor(
            tracknet_file, inpaintnet_file or None, eval_mode=eval_mode, batch_size=batch_size,
            compute_dtype=compute_dtype, input_hw=input_hw, device=device,
            conv_backend=conv_backend, native_decode=native_decode, stage_format=stage_format,
        )
    if stats is None:
        stats = {}
    stats["waves"] = []
    stats["streaming"] = []
    frame_bytes = predictor.h * predictor.w * 3

    def finish(f: str, pred: Dict[str, list], src_wh) -> Dict[str, list]:
        return _finish(predictor, f, pred, src_wh, save_dir, None, output_video, traj_len)

    def guard(f: str, fn):
        """(fn(), True); under on_error="skip" a failure is reported and
        gives (None, False)."""
        if on_error == "raise":
            return fn(), True
        try:
            return fn(), True
        except Exception as e:  # noqa: BLE001 - one video's failure, reported
            print(f"warning: skipping {f}: {e}", file=sys.stderr)
            return None, False

    results: Dict[str, Dict[str, list]] = {}
    wave_budget = staging_budget_bytes / 2
    streaming: List[str] = []
    inflight = threading.Semaphore(2)  # waves uploaded and not yet served
    stop = threading.Event()  # the caller's thread has stopped serving

    def acquire(n: int) -> bool:
        """n slots, or False (and none held) once serving has stopped."""
        got = 0
        while got < n:
            if stop.is_set():
                if got:
                    inflight.release(got)
                return False
            got += inflight.acquire(timeout=0.05)
        return True

    def probe(f: str) -> int:
        reader = open_video(f)
        try:
            return reader.video_len
        finally:
            reader.release()

    def waves() -> Iterator[Tuple[int, List[Tuple[str, UploadedVideo]]]]:
        """The staged waves in order, as (slots, [(file, upload)]): a wave
        takes its slots before its first upload, and they pass with it to
        the caller's thread, which returns them once it has served it."""
        wave: List[Tuple[str, UploadedVideo]] = []
        wave_bytes = slots = 0
        try:
            for f in video_files:
                if stop.is_set():
                    return
                T, ok = guard(f, lambda f=f: probe(f))
                if not ok:
                    continue
                vid_bytes = max(T, 1) * frame_bytes
                if vid_bytes > staging_budget_bytes:
                    streaming.append(f)  # served after the waves
                    continue
                solo = vid_bytes > wave_budget
                if wave and (solo or wave_bytes + vid_bytes > wave_budget):
                    out, wave, wave_bytes, slots = (slots, wave), [], 0, 0
                    yield out
                if not wave:
                    if not acquire(2 if solo else 1):
                        return
                    slots = 2 if solo else 1
                up, ok = guard(f, lambda f=f: predictor.upload_video(f))
                if ok:
                    wave.append((f, up))
                    wave_bytes += vid_bytes
                    if solo:
                        out, wave, wave_bytes, slots = (slots, wave), [], 0, 0
                        yield out
                elif not wave:  # the wave's first video failed: give its slots back
                    inflight.release(slots)
                    slots = 0
            if wave:
                out, slots = (slots, wave), 0
                yield out
        finally:
            if slots:  # a wave that was never handed over
                inflight.release(slots)

    def serve_wave(slots: int, wave: List[Tuple[str, UploadedVideo]]) -> None:
        wave_stat = {"videos": [f for f, _ in wave], "slots": slots, "buckets": []}
        stats["waves"].append(wave_stat)
        staged_wave = []
        for k, (f, up) in enumerate(wave):
            staged, ok = guard(f, lambda up=up: predictor.finalize_staged(up))
            wave[k] = None  # the pinned host copy goes with it
            if ok:
                wave_stat["buckets"].append(staged.T)
                staged_wave.append((f, staged))
        for f, staged in staged_wave:
            pred, ok = guard(f, lambda f=f, staged=staged: finish(
                f, predictor.run_staged(staged, mesh=mesh), staged.src_wh))
            if ok:
                results[f] = pred

    # a producer thread reads and uploads the next wave while this one is served
    with contextlib.closing(_prefetched(waves(), None, depth=1, stop=stop)) as staged_waves:
        for slots, wave in staged_waves:
            try:
                serve_wave(slots, wave)
            finally:
                inflight.release(slots)  # the wave's buffers went in serve_wave

    stats["streaming"] = list(streaming)
    if streaming and mesh is not None:
        print(f"warning: {len(streaming)} video(s) exceed the staging budget and fall back to "
              "single-device streaming (num_devices ignored for them)", file=sys.stderr)
    for f in streaming:
        def stream(f=f):
            reader = open_video(f)
            try:
                src_wh = (reader.w, reader.h)
            finally:
                reader.release()
            return finish(f, predictor.predict_video_streaming(f, max_sample_num=max_sample_num),
                          src_wh)

        pred, ok = guard(f, stream)
        if ok:
            results[f] = pred
    return results
