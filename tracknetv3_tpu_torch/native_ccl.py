"""ctypes bindings for the native connected-components decoder.

The port's copy of the JAX package's loader: builds
``native/libtrackdecode.so`` from ``native/ccl_decode.cpp`` with ``make -C
native`` at first use (g++, no other dependency) and exposes
``decode_heatmaps_native``, the exact largest-bbox-area decode rule on a
thread pool. Returns None where the library cannot be built or loaded;
``ops.detect.decode_heatmaps_host`` then runs ``scipy.ndimage``. The first
load says on stderr which of the two the process runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Dict, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtrackdecode.so")

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
        # make no-ops on an up-to-date library and rebuilds a stale one
        try:
            subprocess.run(["make", "-s", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception as e:
            if not os.path.exists(_LIB_PATH):
                _build_failed = True
                print(f"native_ccl: {_LIB_PATH} did not build; decode_heatmaps_host runs "
                      "scipy.ndimage", file=sys.stderr)
                return None
            err = getattr(e, "stderr", b"") or b""
            print("warning: rebuilding native/libtrackdecode.so failed; using the existing "
                  "(possibly stale) library. make said:\n"
                  f"{err.decode(errors='replace').strip()}", file=sys.stderr)
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            _build_failed = True
            print(f"native_ccl: {_LIB_PATH} did not load ({e}); decode_heatmaps_host runs "
                  "scipy.ndimage", file=sys.stderr)
            return None
        lib.decode_heatmaps_ccl.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.decode_heatmaps_ccl.restype = None
        print(f"native_ccl: decode_heatmaps_host runs {_LIB_PATH}", file=sys.stderr)
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_heatmaps_native(
    probs: np.ndarray, threshold: float = 0.5, n_threads: int = 0
) -> Optional[Dict[str, np.ndarray]]:
    """Decode (..., H, W) heatmaps with the native library: the dict of
    ``ops.detect.decode_heatmaps_host``, or None where the library cannot
    be built or loaded."""
    lib = _load()
    if lib is None:
        return None
    probs = np.ascontiguousarray(probs, dtype=np.float32)
    lead = probs.shape[:-2]
    h, w = probs.shape[-2:]
    flat = probs.reshape(-1, h, w)
    n = flat.shape[0]
    bbox = np.zeros((n, 4), np.int32)
    conf = np.zeros((n,), np.float32)
    center = np.zeros((n, 2), np.int32)
    lib.decode_heatmaps_ccl(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, h, w,
        ctypes.c_float(threshold), bbox.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        conf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        center.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads,
    )
    cx, cy = center[:, 0], center[:, 1]
    vis = ((cx != 0) | (cy != 0)).astype(np.int32)
    return {
        "cx": cx.reshape(lead),
        "cy": cy.reshape(lead),
        "vis": vis.reshape(lead),
        "conf": conf.reshape(lead),
        "bbox": bbox.reshape(lead + (4,)),
    }
