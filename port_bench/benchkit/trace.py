"""Host spans and the device trace.

``Spans`` times the benchmark's own calls into each layer of the program on
the host clock. In the traced run a span opens a
``torch.profiler.record_function`` range named ``bench.<name>``, so the
trace can tell which span the host was in, and the serving spans end with
``torch.cuda.synchronize()``, so the device work a span issued lies inside
it. The untraced run keeps neither: its spans cost two clock reads.

``DeviceTrace`` reads a ``torch.profiler`` trace (exported as a Chrome
trace into the run's temporary directory): every device operation's
interval (kernels, copies, sets), each kernel by name, and the host ranges
``bench.*``. Busy time is the union of the device intervals, so work that
overlaps on two streams counts once.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# kernel categories by name, as ``tracknetv3_tpu_torch/profile_step.py``
# sorts them (a frozen copy): the first list that a name matches wins
CATEGORIES = (
    ("copy_kernels", ("window_copy", "repeat_rows_kernel", "roll_cols_kernel")),
    ("loss_kernels", ("wbce_disk",)),
    ("batchnorm", ("bn_stats", "bn_relu")),
    ("conv3x3", ("conv3x3_",)),
    ("optimizer", ("adam", "multi_tensor", "foreach")),
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "sm90", "implicit", "wgrad", "dgrad")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "cat", "copy")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


class Spans:
    """Seconds of named host spans; ``annotate`` opens a
    profiler range for each, ``sync`` ends each with a synchronise."""

    def __init__(self, annotate: bool = False, sync: bool = False):
        self.annotate, self.sync = annotate, sync
        self.seconds: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        rf = (torch.profiler.record_function(f"bench.{name}") if self.annotate
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                if self.sync:
                    torch.cuda.synchronize()
        self.seconds[name] += time.perf_counter() - t0


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """Stretches of [lo, hi] covered by no interval."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class Profiled:
    """A profiled sub-window: ``torch.profiler`` over the host and the
    device, inside a ``bench.window`` range. ``close`` returns the trace and
    the host seconds the sub-window took, the profiler's stop and the
    reading of its trace included, which the metrics of the rest of the
    window leave out."""

    @staticmethod
    def warm_up(device) -> None:
        """Start the profiler once before the window: its first start loads
        and initialises the device tracer."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)

    def __init__(self, tmp_dir: str):
        import torch

        self.tmp_dir = tmp_dir
        self.t0 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.range = torch.profiler.record_function("bench.window")
        self.range.__enter__()

    def close(self) -> Tuple["DeviceTrace", float]:
        import torch

        torch.cuda.synchronize()
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        trace = DeviceTrace.from_profiler(self.prof, self.tmp_dir)
        return trace, time.perf_counter() - self.t0


class DeviceTrace:
    """The device operations and ``bench.*`` host ranges of one profiled
    sub-window; times in microseconds on the trace's clock."""

    def __init__(self, events: List[Dict], t0_us: float, t1_us: float):
        self.t0, self.t1 = t0_us, t1_us
        self.ops: List[Tuple[str, str, float, float]] = []  # (cat, name, start, end)
        self.ranges: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
            if cat in DEVICE_CATS:
                self.ops.append((cat, e.get("name", ""), ts, ts + dur))
            elif cat == "user_annotation" and e.get("name", "").startswith("bench."):
                self.ranges.append((e["name"][len("bench."):], ts, ts + dur))

    @classmethod
    def from_profiler(cls, prof, tmp_dir: str) -> "DeviceTrace":
        """Export ``prof`` as a Chrome trace into ``tmp_dir``, read it and
        delete the file. The window runs from the first to the last event
        unless the ``bench.window`` range bounds it."""
        path = os.path.join(tmp_dir, "trace.json")
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self = cls(events, 0.0, 0.0)
        win = [r for r in self.ranges if r[0] == "window"]
        if win:
            self.t0, self.t1 = win[0][1], win[0][2]
        elif self.ops:
            self.t0 = min(o[2] for o in self.ops)
            self.t1 = max(o[3] for o in self.ops)
        return self

    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _clipped(self, ops):
        return [(max(a, self.t0), min(b, self.t1)) for _, _, a, b in ops
                if b > self.t0 and a < self.t1]

    def busy_s(self) -> float:
        return union_length(self._clipped(self.ops)) * 1e-6

    def kernels(self, patterns: Iterable[str] = (), within: Optional[str] = None):
        """Kernels whose lowercased name holds one of ``patterns`` (every
        kernel without patterns), optionally only those that start inside a
        ``bench.<within>`` range."""
        pats = [p.lower() for p in patterns]
        spans = [(a, b) for n, a, b in self.ranges if n == within] if within else None
        out = []
        for cat, name, a, b in self.ops:
            if cat != "kernel" or a < self.t0 or a >= self.t1:
                continue
            if pats and not any(p in name.lower() for p in pats):
                continue
            if spans is not None and not any(s <= a < e for s, e in spans):
                continue
            out.append((name, a, b))
        return out

    def kernel_seconds(self, patterns: Iterable[str] = (), within: Optional[str] = None) -> float:
        return sum(b - a for _, a, b in self.kernels(patterns, within)) * 1e-6

    def by_category(self) -> Dict[str, float]:
        """Kernel seconds by ``category`` of their names."""
        by: Dict[str, float] = defaultdict(float)
        for name, a, b in self.kernels():
            by[category(name)] += (b - a) * 1e-6
        return dict(sorted(by.items(), key=lambda kv: -kv[1]))

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for cat, name, a, b in self.ops:
            if a >= self.t0 and a < self.t1:
                by[name] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time by the innermost ``bench.*`` range the host was
        in at each gap's middle (``none`` outside every range)."""
        by: Dict[str, float] = defaultdict(float)
        inner = [r for r in self.ranges if r[0] != "window"]
        for a, b in gaps(self._clipped(self.ops), self.t0, self.t1):
            mid = 0.5 * (a + b)
            hits = [r for r in inner if r[1] <= mid < r[2]]
            name = min(hits, key=lambda r: r[2] - r[1])[0] if hits else "none"
            by[name] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
