"""Build the repository's host C++ libraries (``native/*.cpp``) for the port.

Each source is compiled by ``g++`` into the repository's git-ignored
``build/`` directory, under a name that hashes the source and the flags,
at its first use in a process. The compiler writes a temporary file of its
own, which ``os.replace`` moves into place: processes that build the same
library at once each load a whole file, never one another's half-written
output. Nothing is written into ``native/``, whose ``Makefile`` the JAX
package runs.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

ROOT = Path(__file__).resolve().parents[1]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


def library_path(source: str, libs: Sequence[str] = ()) -> Path:
    src = (NATIVE_DIR / source).read_bytes()
    flags = " ".join(CXX_FLAGS + tuple(libs)).encode()
    digest = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build(source: str, libs: Sequence[str] = ()) -> Path:
    """Compile ``native/<source>`` linked with ``libs`` unless its library
    exists; returns its path. Raises ``RuntimeError`` where the source, the
    compiler or a library is missing or the build fails."""
    try:
        out = library_path(source, libs)
    except OSError as e:
        raise RuntimeError(f"cannot read native/{source}: {e}") from e
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / source), "-lpthread", *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ did not run on native/{source}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on native/{source} ({proc.returncode}):\n"
                           f"{proc.stderr.strip()}")
    os.replace(tmp, out)
    return out
