"""Build and load the port's hand-written CUDA kernels.

Each source in ``tracknetv3_tpu_torch/csrc/`` has a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` into a shared library under the
repository's ``build/`` directory, named by a hash of the source and the
flags, at its first use in a process. The library is loaded with
``ctypes``. A missing ``nvcc`` or a failed build raises.

No ``--use_fast_math``: the WBCE backward's clamp masks must test exactly
the forward's condition, and approximate ``expf``/``logf`` move it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# the H100's shared memory per SM; each resident block takes 1 KB more of it
SMEM_PER_SM = 233_472
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(source: str) -> Path:
    src = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` unless its library exists; returns the
    library path and the compiler's output (register and shared-memory
    use from ``-Xptxas -v``; empty when the library was already built)."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source} ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and load it; each kernel module
    keeps the loaded library for the life of the process."""
    return ctypes.CDLL(str(build(source)[0]))


@functools.lru_cache(maxsize=None)
def num_sms(device) -> int:
    """The card's SM count, which sizes the persistent grids."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
