"""ctypes bindings for the native libav video decoder (the port's copy of
the JAX package's ``native_video.py``).

``native/video_decode.cpp``: libavformat / libavcodec decode, with
DCT-domain ``lowres`` on mpeg4-family codecs, then libswscale's scale and
convert straight to the model's input resolution; or, for
``read_into_yuv``, planar YUV420 at that resolution, half the bytes of
packed BGR, which the serving path converts to RGB on the device
(``ops.preprocess.yuv420_to_rgb``). It takes the place of
``cv2.VideoCapture`` on the staged serving path, which converts every
frame to BGR at the source resolution before the host resize.

The library is built with g++ into ``build/`` at first use
(``native_build``, linked with ``-lavformat -lavcodec -lswscale
-lavutil``); where g++ or libav is missing, ``open_native_video`` returns
None and the callers read with cv2. The first load says on stderr which
decoder the process runs.
"""

from __future__ import annotations

import ctypes
import sys
import threading
from typing import Optional, Tuple

import numpy as np

from . import native_build

SOURCE = "video_decode.cpp"
LIBS = ("-lavformat", "-lavcodec", "-lswscale", "-lavutil")

_lib = None
_lock = threading.Lock()
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            path = native_build.build(SOURCE, LIBS)
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as e:
            _build_failed = True
            print(f"native_video: native/{SOURCE} did not build or load ({e}); "
                  "videos decode with cv2", file=sys.stderr)
            return None
        c_int, c_ptr_u8 = ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)
        lib.vdec_open.restype = ctypes.c_void_p
        lib.vdec_open.argtypes = [
            ctypes.c_char_p, c_int, c_int, c_int, ctypes.POINTER(c_int), ctypes.POINTER(c_int),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(c_int),
        ]
        lib.vdec_read.restype = c_int
        lib.vdec_read.argtypes = [ctypes.c_void_p, c_ptr_u8, c_int, c_int]
        lib.vdec_read_yuv.restype = c_int
        lib.vdec_read_yuv.argtypes = [ctypes.c_void_p, c_ptr_u8, c_int]
        lib.vdec_close.restype = None
        lib.vdec_close.argtypes = [ctypes.c_void_p]
        lib.venc_write_test_clip.restype = c_int
        lib.venc_write_test_clip.argtypes = [ctypes.c_char_p, ctypes.c_char_p, c_int, c_int,
                                             c_int]
        print(f"native_video: videos decode with libav ({path})", file=sys.stderr)
        _lib = lib
        return _lib


def _check_buffer(out: np.ndarray, frame_shape: Tuple[int, ...]) -> None:
    """The library writes whole frames of ``frame_shape`` into ``out``'s
    memory: refuse any other buffer before its pointer is passed."""
    if (out.dtype != np.uint8 or not out.flags.c_contiguous or not out.flags.writeable
            or out.shape[1:] != frame_shape):
        raise ValueError(f"need a C-contiguous writable (N, {', '.join(map(str, frame_shape))}) "
                         f"uint8 array, got {out.dtype} {out.shape}")


class NativeVideoReader:
    """Decode a video to packed (N, out_h, out_w, 3) uint8 batches, or to
    planar YUV420 rows.

    ``lowres`` asks the codec for DCT-domain reduced-resolution decode
    (mpeg4-family; clamped to the codec's maximum, ``applied_lowres`` says
    what was granted); ``-1`` picks the largest level whose decoded size
    still covers (out_w, out_h), so scaling always goes down. ``src_w``,
    ``src_h`` and ``fps`` describe the full-resolution stream whatever the
    lowres, so coordinate scaling is unaffected.
    """

    def __init__(self, video_file: str, out_w: int, out_h: int, lowres: int = 0,
                 bgr: bool = True):
        lib = _load()
        if lib is None:
            raise RuntimeError("native video decoder unavailable")
        sw, sh, alr = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        nf, fps = ctypes.c_longlong(), ctypes.c_double()
        self._h = lib.vdec_open(video_file.encode(), out_w, out_h, lowres, ctypes.byref(sw),
                                ctypes.byref(sh), ctypes.byref(nf), ctypes.byref(fps),
                                ctypes.byref(alr))
        if not self._h:
            raise RuntimeError(f"native open failed: {video_file}")
        self._lib = lib
        self.out_w, self.out_h = out_w, out_h
        self.src_w, self.src_h = sw.value, sh.value
        self.n_frames = int(nf.value)  # -1 where the container does not say
        self.fps = fps.value
        self.applied_lowres = alr.value
        self.bgr = bgr

    def read_batch(self, max_frames: int) -> Optional[np.ndarray]:
        """The next ``<= max_frames`` frames, or None at the end."""
        out = np.empty((max_frames, self.out_h, self.out_w, 3), np.uint8)
        n = self.read_into(out)
        return out[:n] if n > 0 else None

    def read_into(self, out: np.ndarray) -> int:
        """Decode into a C-contiguous (N, out_h, out_w, 3) uint8 array
        (BGR or RGB as ``bgr`` says); returns the frames written (0 at the
        end) and raises on a decode error. The foreign call releases the
        GIL, so a producer thread decodes while the caller's thread runs."""
        if self._h is None:
            return 0
        _check_buffer(out, (self.out_h, self.out_w, 3))
        n = self._lib.vdec_read(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                int(out.shape[0]), 1 if self.bgr else 0)
        if n < 0:
            raise RuntimeError("native video decode error")
        return n

    def read_into_yuv(self, out: np.ndarray) -> int:
        """Decode into a C-contiguous (N, out_h*out_w*3//2) uint8 array of
        planar YUV420 frames (each Y[h*w], U[h/2*w/2], V[h/2*w/2]); returns
        the frames written (0 at the end) and raises on a decode error.
        The output size must be even: the library checks at the first read
        and fails it, so callers that want to fail early check first."""
        if self._h is None:
            return 0
        _check_buffer(out, (self.out_h * self.out_w * 3 // 2,))
        n = self._lib.vdec_read_yuv(self._h,
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                    int(out.shape[0]))
        if n < 0:
            raise RuntimeError("native video decode error (yuv420)")
        return n

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.vdec_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def open_native_video(video_file: str, out_w: int, out_h: int, lowres: int = 0,
                      bgr: bool = True) -> Optional[NativeVideoReader]:
    """A ``NativeVideoReader``, or None where the library is missing or the
    file does not open."""
    try:
        return NativeVideoReader(video_file, out_w, out_h, lowres=lowres, bgr=bgr)
    except Exception:
        return None


def write_test_clip(video_file: str, codec: str = "libx264", n: int = 24, w: int = 1280,
                    h: int = 720) -> bool:
    """Encode a synthetic moving-square clip with the named libav codec (a
    test fixture: cv2's bundled ffmpeg does not encode h264); True on
    success."""
    lib = _load()
    if lib is None:
        return False
    return lib.venc_write_test_clip(video_file.encode(), codec.encode(), n, w, h) == 0


def probe_video(video_file: str) -> Optional[Tuple[int, int, int, float]]:
    """(src_w, src_h, n_frames, fps) from the native decoder, else None."""
    r = open_native_video(video_file, 64, 36)
    if r is None:
        return None
    try:
        return (r.src_w, r.src_h, r.n_frames, r.fps)
    finally:
        r.close()
