"""train.conv_roofline: % of the least time a step's convolutions need
(each conv's forward, weight gradient and data gradient but the first
layer's, the 1x1 predictor included, at the bf16 peak;
``benchkit/roofline.py``) over the device time of the kernels whose name
matches ``roofline.CONV_PATTERNS``, over the traced steps."""

from benchkit import roofline


def read(run):
    if run.kind != "train" or run.trace is None or not run.traced.get("steps"):
        return None
    device_s = run.trace.kernel_seconds(roofline.CONV_PATTERNS)
    bound = roofline.train_conv_bound_s(run.model, run.batch) * run.traced["steps"]
    return roofline.percent(bound, device_s)
