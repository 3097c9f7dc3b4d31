"""serve.fetch_wait_ms: ms per 1000 frames the host spends in the chunk
loop's one fetch of the decoded rows, which waits for every chunk's device
work still queued: the program's span ``serve::fetch``
(``tracknetv3_tpu_torch.utils.profiling``), host clock, over the profiled
sub-window's frames."""


def read(run):
    if run.kind != "serve" or run.traced.get("frames", 0) <= 0:
        return None
    s = _span_seconds(run, ("serve::fetch",))
    return None if s is None else s * 1e6 / run.traced["frames"]


def _recorded(run):
    """The program's ``profiling.recorded()``: what its spans and counters
    recorded while a profiler ran, which in a harness run is the profiled
    sub-window alone. None without a trace, or for a program without that
    registry."""
    if run.trace is None:
        return None
    try:
        from tracknetv3_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return recorded() if callable(recorded) else None


def _span_seconds(run, names):
    """Host seconds in the program spans ``names``; None where none was
    recorded."""
    rec = _recorded(run)
    hits = [rec["spans"][n]["s"] for n in names if n in rec["spans"]] if rec else []
    return sum(hits) if hits else None
