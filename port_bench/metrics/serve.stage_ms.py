"""serve.stage_ms: ms per 1000 frames served, spent in staging:
``upload_staged`` and ``finalize_staged`` (the pinned copy, YUV420 -> RGB,
the median). The benchmark's span around the calls, host clock, ended by a
synchronise in the traced run; over the window's clips outside the
profiled sub-window."""


def read(run):
    if run.kind != "serve" or run.untraced_frames <= 0 or "stage" not in run.spans:
        return None
    return run.spans["stage"] * 1e6 / run.untraced_frames
