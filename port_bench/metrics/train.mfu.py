"""train.mfu: % of the card's bf16 peak that the model FLOPs of the
window's steps (3 x the forward x the batch;
``benchkit/roofline.train_flops``) take over its wall time, the profiled
sub-window left out: the whole train step's share of the peak."""

from benchkit import roofline


def read(run):
    if run.kind != "train" or run.untraced_steps <= 0 or run.untraced_s <= 0:
        return None
    flops = roofline.train_flops(run.model, run.batch) * run.untraced_steps
    return 100.0 * flops / run.untraced_s / roofline.BF16_FLOPS
