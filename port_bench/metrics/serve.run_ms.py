"""serve.run_ms: ms per 1000 frames served, spent in the chunk loop:
``run_staged`` (window preprocessing, the folded forward, the ensemble, the
decode, the one fetch). The benchmark's span around the call, host clock,
ended by a synchronise in the traced run; over the window's clips outside the
profiled sub-window."""


def read(run):
    if run.kind != "serve" or run.untraced_frames <= 0 or "run" not in run.spans:
        return None
    return run.spans["run"] * 1e6 / run.untraced_frames
