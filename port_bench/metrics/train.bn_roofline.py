"""train.bn_roofline: % of the least time the 17 train-mode BatchNorm +
ReLU layers need (each input read once and each output written once:
forward y in and out, backward the gradient and y in and dy out, bf16, at
the HBM rate; ``benchkit/roofline.py``) over the device time of the
kernels whose name matches ``roofline.BN_PATTERNS``, over the traced
steps."""

from benchkit import roofline


def read(run):
    if run.kind != "train" or run.trace is None or not run.traced.get("steps"):
        return None
    device_s = run.trace.kernel_seconds(roofline.BN_PATTERNS)
    bound = roofline.bn_bound_s(run.model, run.batch) * run.traced["steps"]
    return roofline.percent(bound, device_s)
