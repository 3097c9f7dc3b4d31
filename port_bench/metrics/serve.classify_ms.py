"""serve.classify_ms: device milliseconds per 1000 frames of TrackNetV1's
256-way channel argmax (``models/fused_forward.class_maps``, inside the
program's ``serve::classify`` span): the device time of the kernels whose
name holds ``argmax`` (torch's ``ArgMaxOps`` reduction today) and that
start inside ``run_staged`` (``bench.run``), over the profiled sub-window's
frames. Device time, so the host's waits on a full launch queue do not
enter it; the cast of the argmax to float32 and its division by 255 are
left out. Silent where no such kernel ran: the U-Net, or a program
without TrackNetV1."""

PATTERNS = ("argmax",)


def read(run):
    if run.kind != "serve" or run.trace is None or run.traced.get("frames", 0) <= 0:
        return None
    kernels = run.trace.kernels(PATTERNS, within="run")
    if not kernels:
        return None
    return sum(b - a for _, a, b in kernels) / run.traced["frames"]  # us / frame = ms / kframe
