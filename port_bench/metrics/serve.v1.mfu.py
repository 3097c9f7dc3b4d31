"""serve.v1.mfu: % of the card's bf16 peak that TrackNetV1's model FLOPs
of the windows forwarded (every real window of the clips, one a frame from
frame 2 on; ``benchkit/roofline_v1.forward_flops``, 367.6 GFLOP a window at
360x640) take over the wall time, the profiled sub-window left out: the
whole serving step's share of the peak."""

from benchkit import roofline_v1


def read(run):
    if (run.kind != "serve" or run.untraced_windows <= 0 or run.untraced_s <= 0
            or not roofline_v1.is_v1(run.model)):
        return None
    flops = roofline_v1.forward_flops(run.model) * run.untraced_windows
    return 100.0 * flops / run.untraced_s / roofline_v1.BF16_FLOPS
