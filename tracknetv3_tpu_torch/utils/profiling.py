"""The port's tracing: spans, counters and the ``--profile DIR`` exporter.

**Spans.** ``span(name)`` marks a stretch of host work on the serving and
training paths (``serve::decode``, ``train::backward``, ...). While a
``torch.profiler`` records on this thread, a span opens a
``torch.profiler.record_function`` range of that name, which lands on the
profiler's timeline beside the device's kernels and copies, and adds its
host seconds and a count to the recorded view (``recorded()``). Otherwise
it checks the profiler's flag and does nothing else: there is no switch
but the profiler that ``--profile DIR`` (``trace``) or a caller starts.

**Counters.** ``count(name, n)`` adds ``n`` to a counter, always (an int
add): each hand kernel's launches as ``launch.<kernel>`` and the bytes
every host-to-device copy of the hot paths moves as ``h2d_bytes``
(``h2d``). While recording, the same increments also go into the recorded
view. ``counters()`` returns a snapshot of the totals, ``recorded()`` the
recorded view (span seconds and counts, counters), ``reset()`` zeroes the
totals and empties the recorded view. The registry is one per process;
a counter is written by one thread at a time on the program's paths (a
producer thread that uploads counts into the totals alone: the profiler
records the thread that started it).

**Exporter.** ``trace(dir)`` profiles a block into ``dir/trace.json``, a
chrome trace (Perfetto or ``chrome://tracing`` open it), and writes
``dir/spans.json`` beside it from the same trace's events, on its one
clock (``summarize``): each program span's host seconds and count, the
counters recorded in the block, the device's idle seconds put down to the
innermost program span open on the host at each idle gap's middle
(``none`` outside every span), and the host's synchronisations with the
device by the innermost program span they were issued in.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch

_recording = torch.autograd._profiler_enabled  # about 0.1 us a call

_totals: Dict[str, int] = {}
_recorded_counts: Dict[str, int] = {}
_span_s: Dict[str, float] = {}
_span_n: Dict[str, int] = {}

# device operations of a chrome trace, and the host calls that wait for the
# device (a blocking ``cudaMemcpy`` waits for the stream it copies on)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


class _Off:
    """The span while nothing records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(name)

    def __enter__(self) -> None:
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        _span_s[self.name] = _span_s.get(self.name, 0.0) + dt
        _span_n[self.name] = _span_n.get(self.name, 0) + 1
        return False


def span(name: str):
    """A context manager: the profiler range ``name`` and its host seconds
    while a profiler records on this thread, else nothing."""
    return _Span(name) if _recording() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, and to its recorded view while a
    profiler records on this thread."""
    _totals[name] = _totals.get(name, 0) + n
    if _recording():
        _recorded_counts[name] = _recorded_counts.get(name, 0) + n


def declare(*names: str) -> None:
    """Counters that read 0 in ``counters()`` before their first count (a
    kernel module's launch counters)."""
    for name in names:
        _totals.setdefault(name, 0)


def h2d(t: torch.Tensor, device, non_blocking: bool = False) -> torch.Tensor:
    """``t.to(device, non_blocking=non_blocking)``, counting its bytes under
    ``h2d_bytes`` where it crosses from the host to another device."""
    out = t.to(device, non_blocking=non_blocking)
    if t.device.type == "cpu" and out.device.type != "cpu":
        count("h2d_bytes", t.numel() * t.element_size())
    return out


def counters() -> Dict[str, int]:
    """A snapshot of every counter's total."""
    return dict(_totals)


def recorded() -> Dict[str, Dict]:
    """What the spans and counters recorded while a profiler ran:
    ``{"spans": {name: {"s": host seconds, "n": count}}, "counters":
    {name: total}}``."""
    return {"spans": {k: {"s": _span_s[k], "n": _span_n[k]} for k in _span_s},
            "counters": dict(_recorded_counts)}


def reset() -> None:
    """Zero every counter's total and empty the recorded view."""
    for k in _totals:
        _totals[k] = 0
    _recorded_counts.clear()
    _span_s.clear()
    _span_n.clear()


# ------------------------------------------------------------ the trace


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(spans: List[Tuple[str, float, float]], times: List[float]) -> List[str]:
    """For each of the ascending ``times``, the shortest program span open
    then (``none`` outside every one): one sweep over the spans by start."""
    order = sorted(spans, key=lambda s: s[1])
    active: List[Tuple[str, float, float]] = []
    out, i = [], 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            active.append(order[i])
            i += 1
        active = [s for s in active if s[2] > t]
        out.append(min(active, key=lambda s: s[2] - s[1])[0] if active else "none")
    return out


def summarize(events: Iterable[Dict]) -> Dict:
    """What ``spans.json`` holds, from a chrome trace's ``traceEvents``
    (times in microseconds): ``spans`` (each program span's host seconds
    and count: ``user_annotation`` ranges named ``<area>::<what>``),
    ``window_s`` (the first event's start to the last one's end), ``busy_s``
    (the union of device operations), ``idle_s`` and ``idle_by_span`` (each
    idle gap by the innermost program span open at its middle; the values
    sum to ``idle_s``), and ``syncs_by_span`` (the host's ``SYNC_CALLS`` by
    the innermost program span open at their start: count and seconds)."""
    spans: List[Tuple[str, float, float]] = []
    ops: List[Tuple[float, float]] = []
    syncs: List[Tuple[str, float, float]] = []
    lo = hi = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        lo = a if lo is None else min(lo, a)
        hi = b if hi is None else max(hi, b)
        if cat in DEVICE_CATS:
            ops.append((a, b))
        elif cat == "user_annotation" and "::" in name:
            spans.append((name, a, b))
        elif cat == "cuda_runtime" and name in SYNC_CALLS:
            syncs.append((name, a, b))
    by_span: Dict[str, Dict[str, float]] = {}
    for name, a, b in spans:
        s = by_span.setdefault(name, {"s": 0.0, "n": 0})
        s["s"] += (b - a) * 1e-6
        s["n"] += 1
    busy = idle = 0.0
    gaps: List[Tuple[float, float]] = []
    if lo is not None:
        cur = lo
        for a, b in _union(ops) + [(hi, hi)]:
            if a > cur:
                gaps.append((cur, a))
            busy += b - a
            cur = max(cur, b)
    idle_by: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(spans, [0.5 * (a + b) for a, b in gaps])):
        idle_by[name] += (b - a) * 1e-6
        idle += (b - a) * 1e-6
    syncs.sort(key=lambda s: s[1])
    syncs_by: Dict[str, Dict[str, float]] = {}
    for (_, a, b), name in zip(syncs, _innermost(spans, [a for _, a, _ in syncs])):
        s = syncs_by.setdefault(name, {"n": 0, "s": 0.0})
        s["n"] += 1
        s["s"] += (b - a) * 1e-6
    return {"spans": by_span,
            "window_s": (hi - lo) * 1e-6 if lo is not None else 0.0,
            "busy_s": busy * 1e-6, "idle_s": idle,
            "idle_by_span": dict(sorted(idle_by.items(), key=lambda kv: -kv[1])),
            "syncs_by_span": dict(sorted(syncs_by.items(), key=lambda kv: -kv[1]["s"]))}


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into ``log_dir/trace.json`` and ``spans.json``
    (no-op if empty or None). A block that raises writes neither."""
    if not log_dir:
        yield
        return
    before = dict(_recorded_counts)
    with torch.profiler.profile() as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        out = summarize(json.load(f)["traceEvents"])
    out["counters"] = {k: v - before.get(k, 0) for k, v in _recorded_counts.items()
                       if v != before.get(k, 0)}
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(out, f, indent=1)
