"""frames_per_s: the frames of every clip completed in the window over the
window's seconds (host clock, from the first upload to the last CSV)."""


def read(run):
    if run.kind != "serve" or not run.clips or run.window_s <= 0:
        return None
    return run.frames / run.window_s
