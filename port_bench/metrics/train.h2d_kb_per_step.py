"""train.h2d_kb_per_step: KB (1024 bytes) a step that the train path copies
from the host to the card: the program's counter ``h2d_bytes``
(``tracknetv3_tpu_torch.utils.profiling``) as recorded over the profiled
sub-window, over its steps."""


def read(run):
    if run.kind != "train" or run.traced.get("steps", 0) <= 0:
        return None
    rec = _recorded(run)
    if rec is None:
        return None
    return rec["counters"].get("h2d_bytes", 0) / 1024 / run.traced["steps"]


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
