"""The per-layer metrics that read the program's own spans and counters
(``tracknetv3_tpu_torch.utils.profiling.recorded()``): each on a run record
with a seeded registry, normalised by the profiled sub-window's frames or
steps (``run.traced``), and silent (None) without a trace, with an empty
sub-window, or against a program that has no such registry."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from benchkit.run_record import RunRecord  # noqa: E402
from benchkit.spec import metric_reader  # noqa: E402
from benchkit.trace import DeviceTrace  # noqa: E402
from conftest import ROOT  # noqa: E402
from tracknetv3_tpu_torch.utils import profiling  # noqa: E402

SEEDED = {"spans": {"serve::preprocess": {"s": 0.25, "n": 10},
                    "serve::forward": {"s": 0.75, "n": 10},
                    "serve::ensemble": {"s": 0.5, "n": 10},
                    "serve::decode": {"s": 1.5, "n": 11},
                    "serve::fetch": {"s": 0.02, "n": 2},
                    "train::assemble": {"s": 0.6, "n": 50}},
          "counters": {"h2d_bytes": 51200, "launch.conv3x3_9tap": 170}}
# metric: (run kind, traced sub-window, value of SEEDED)
WANT = {"serve.forward_ms": ("serve", {"frames": 2000}, 1.0 * 1e6 / 2000),
        "serve.decode_ms": ("serve", {"frames": 2000}, 2.0 * 1e6 / 2000),
        "serve.fetch_wait_ms": ("serve", {"frames": 2000}, 0.02 * 1e6 / 2000),
        "train.assemble_ms": ("train", {"steps": 50}, 0.6 * 1e3 / 50),
        "train.h2d_kb_per_step": ("train", {"steps": 50}, 51200 / 1024 / 50)}


def _run(kind, traced, trace=True):
    return RunRecord(kind=kind, model={}, traced=dict(traced),
                     trace=DeviceTrace([], 0.0, 1.0) if trace else None)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reads_the_seeded_registry_per_frame_or_step(name, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: SEEDED)
    kind, traced, want = WANT[name]
    read = metric_reader(name, ROOT).read
    assert read(_run(kind, traced)) == pytest.approx(want)
    # normalised by the sub-window's own count
    doubled = {k: 2 * v for k, v in traced.items()}
    assert read(_run(kind, doubled)) == pytest.approx(want / 2)


@pytest.mark.parametrize("name", sorted(WANT))
def test_silent_without_a_trace_an_empty_window_or_the_registry(name, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: SEEDED)
    kind, traced, _ = WANT[name]
    read = metric_reader(name, ROOT).read
    assert read(_run(kind, traced, trace=False)) is None
    assert read(_run(kind, {k: 0 for k in traced})) is None
    assert read(_run("train" if kind == "serve" else "serve", traced)) is None
    monkeypatch.delattr(profiling, "recorded")  # a program before its tracing module
    assert read(_run(kind, traced)) is None


def test_a_span_the_program_did_not_record_reads_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", lambda: {"spans": {}, "counters": {}})
    assert metric_reader("serve.decode_ms", ROOT).read(_run("serve", {"frames": 10})) is None
    # a counter that never counted read 0 bytes
    assert metric_reader("train.h2d_kb_per_step", ROOT).read(_run("train", {"steps": 5})) == 0


def test_reads_what_the_program_recorded_under_a_profiler():
    profiling.reset()
    try:
        with torch.profiler.profile():
            for _ in range(4):
                with profiling.span("train::assemble"):
                    pass
                profiling.count("h2d_bytes", 256)
        profiling.count("h2d_bytes", 10_000)  # outside the profiler: not recorded
        run = _run("train", {"steps": 4})
        s = profiling.recorded()["spans"]["train::assemble"]["s"]
        assert metric_reader("train.assemble_ms", ROOT).read(run) == pytest.approx(s * 1e3 / 4)
        assert metric_reader("train.h2d_kb_per_step", ROOT).read(run) == 0.25
    finally:
        profiling.reset()
