"""train_step_ms: the window's seconds x 1000 over the train steps
completed in it, the input pipeline running; the window ends with a
synchronise. Host clock."""


def read(run):
    if run.kind != "train" or run.steps <= 0:
        return None
    return run.window_s * 1e3 / run.steps
