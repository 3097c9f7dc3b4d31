"""serve.post_ms: ms per 1000 frames served, spent in the trajectory and
its output: ``inpaint_trajectory`` (with an InpaintNet) and
``write_pred_csv``. The benchmark's span around the calls, host clock,
ended by a synchronise in the traced run; over the window's clips outside the
profiled sub-window."""


def read(run):
    if run.kind != "serve" or run.untraced_frames <= 0 or "post" not in run.spans:
        return None
    return run.spans["post"] * 1e6 / run.untraced_frames
