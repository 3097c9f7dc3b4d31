"""serve.v1.conv_roofline: % of the least time TrackNetV1's 18 3x3 convs
need over every real window of the traced clips (for each conv the larger
of its FLOPs at the bf16 peak and its bytes at the HBM rate, from the
configuration's own channels; ``benchkit/roofline_v1.py``) over the device
time of the kernels that compute them: kernels whose name matches
``roofline.CONV_PATTERNS`` and that start inside ``run_staged``. The ReLU
-> BatchNorm epilogue runs inside those kernels, so its cost is in the
share."""

from benchkit import roofline_v1


def read(run):
    if (run.kind != "serve" or run.trace is None or not run.traced.get("windows")
            or not roofline_v1.is_v1(run.model)):
        return None
    device_s = run.trace.kernel_seconds(roofline_v1.CONV_PATTERNS, within="run")
    return roofline_v1.percent(roofline_v1.conv_bound_s(run.model, run.traced["windows"]),
                               device_s)
