"""train.assemble_ms: ms per step the host spends assembling the train
step's inputs (the window gather, the mixup draws' copies and the targets,
up to the forward): the program's span ``train::assemble``
(``tracknetv3_tpu_torch.utils.profiling``), host clock, waits for the
device included, over the profiled sub-window's steps."""


def read(run):
    if run.kind != "train" or run.traced.get("steps", 0) <= 0:
        return None
    s = _span_seconds(run, ("train::assemble",))
    return None if s is None else s * 1e3 / run.traced["steps"]


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
