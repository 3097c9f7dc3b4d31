"""The roofline module's work, counted from the configurations' own channel
counts, against the hand counts: 227.5 / 224.4 GFLOP of 3x3 convs a
window, 227.6 / 224.5 with the 1x1 predictor; 1.486 GB of bf16 BatchNorm
inputs a README train step, so 2.218 ms at 3.35 TB/s for its five passes;
about 6.8 TFLOP of convolutions a step."""

from __future__ import annotations

import json
import os

import pytest

from conftest import BENCH_DIR


def _model(name):
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)["model"]


def test_forward_work_matches_the_hand_count():
    from benchkit import roofline

    v3, v2 = _model("tracknetv3"), _model("tracknetv2")
    assert roofline.in_channels(v3) == 27 and roofline.in_channels(v2) == 9
    assert len(roofline.conv_layers(v3)) == 17
    assert roofline.conv_flops(v3) / 1e9 == pytest.approx(227.455, abs=5e-3)
    assert roofline.conv_flops(v2) / 1e9 == pytest.approx(224.397, abs=5e-3)
    assert roofline.forward_flops(v3) / 1e9 == pytest.approx(227.606, abs=5e-3)
    assert roofline.forward_flops(v2) / 1e9 == pytest.approx(224.454, abs=5e-3)


def test_train_step_work_matches_the_hand_count():
    from benchkit import roofline

    v3 = _model("tracknetv3")
    assert roofline.bn_bytes(v3, 10) / 5 / 1e9 == pytest.approx(1.48636, abs=1e-4)
    assert roofline.bn_bound_s(v3, 10) * 1e3 == pytest.approx(2.2184, abs=1e-3)
    assert roofline.train_conv_flops(v3, 10) / 1e12 == pytest.approx(6.78, abs=0.01)
    assert roofline.train_flops(v3, 10) / 1e12 == pytest.approx(6.83, abs=0.01)


def test_shares_of_a_roofline():
    from benchkit import roofline

    v3 = _model("tracknetv3")
    # a window's convs are compute-bound: the bound is the FLOPs at the bf16 peak, and
    # a little more for the layers whose bytes bound them
    flops_s = roofline.forward_flops(v3) / roofline.BF16_FLOPS
    assert flops_s <= roofline.serve_conv_bound_s(v3, 1) <= 1.1 * flops_s
    assert roofline.percent(1.0, 2.0) == 50.0 and roofline.percent(1.0, 0.0) is None
