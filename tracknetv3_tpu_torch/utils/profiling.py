"""Profiling hook of the CLIs' ``--profile DIR``.

``trace(dir)`` records a ``torch.profiler`` trace (host and, on the card,
device activity) around a section and writes it to ``dir/trace.json`` as a
chrome trace (Perfetto or ``chrome://tracing`` open it).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into ``log_dir/trace.json`` (no-op if empty or
    None). A block that raises writes no trace."""
    if not log_dir:
        yield
        return
    import torch

    with torch.profiler.profile() as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
