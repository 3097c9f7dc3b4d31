"""serve.conv_roofline: % of the least time the forward's convolutions
need (the 17 3x3 convs and the 1x1 predictor of every real window of the
traced clips: for each conv the larger of its FLOPs at the bf16 peak and
its bytes at the HBM rate; ``benchkit/roofline.py``) over the device time
of the kernels that compute them: kernels whose name matches
``roofline.CONV_PATTERNS`` and that start inside ``run_staged``."""

from benchkit import roofline


def read(run):
    if run.kind != "serve" or run.trace is None or not run.traced.get("windows"):
        return None
    device_s = run.trace.kernel_seconds(roofline.CONV_PATTERNS, within="run")
    return roofline.percent(roofline.serve_conv_bound_s(run.model, run.traced["windows"]),
                            device_s)
