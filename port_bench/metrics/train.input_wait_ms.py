"""train.input_wait_ms: ms per step the train loop waits for its next
batch (the loader and ``prefetch_to_device``): the benchmark's span around
that wait, host clock, over the window's steps outside the profiled
sub-window."""


def read(run):
    if run.kind != "train" or run.untraced_steps <= 0 or "input" not in run.spans:
        return None
    return run.spans["input"] * 1e3 / run.untraced_steps
