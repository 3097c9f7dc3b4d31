"""serve.mfu: % of the card's bf16 peak that the model FLOPs of the
windows forwarded (every real window of the clips, the 1x1 predictor
included; ``benchkit/roofline.forward_flops``) take over the wall time, the
profiled sub-window left out: the whole serving step's share of the
peak."""

from benchkit import roofline


def read(run):
    if run.kind != "serve" or run.untraced_windows <= 0 or run.untraced_s <= 0:
        return None
    flops = roofline.forward_flops(run.model) * run.untraced_windows
    return 100.0 * flops / run.untraced_s / roofline.BF16_FLOPS
