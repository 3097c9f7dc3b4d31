"""serve.idle_share: % of the traced sub-window in which no operation
(kernel, copy or set) runs on the device on any stream: 1 - the union of
the device intervals over the sub-window's length, from the profiler's
trace."""


def read(run):
    if run.kind != "serve" or run.trace is None or run.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
