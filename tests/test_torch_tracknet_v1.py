"""TrackNetV1 (the original TrackNet, ``models/tracknet_v1.py``) and its
serving forward on the CPU, held to the benchmark's plain reference
(``port_bench/reference/tracknet_v1.py``: the published ``BallTrackerNet``
in plain float32 torch, which imports nothing of the port):

- the float32 module within ``F32_REL`` of the largest logit;
- the folded forward (``tracknet_v1_fused_forward``, plain versions of the
  kernels) at float32 within ``F32_REL`` on every backend, and at bfloat16
  within ``BF16_REL``; the same forward checked against a reference that
  puts the BatchNorm before the ReLU fails those bounds;
- the conv's ReLU -> affine epilogue mode (``conv3x3_bias_relu_plain``) is
  ``F.conv2d`` + bias, ReLU, the float32 multiply and add, one rounding;
- ``class_maps``: the argmax ties to the first class, and ``gray / 255``
  crosses the decode's 0.5 between 127 and 128;
- the U-Net's forward calls the conv kernels as before: 17 calls, none in
  the new mode, its output bit-equal to the old epilogue's formula.

Weights: the module's seeded init with the BatchNorm statistics and
affine drawn away from the identity, so that the order of ReLU and
BatchNorm matters. 32x64, batch 2.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import torch.nn.functional as F  # noqa: E402

from tracknetv3_tpu_torch.models import fused_forward as ff  # noqa: E402
from tracknetv3_tpu_torch.models import tracknet_v1  # noqa: E402
from tracknetv3_tpu_torch.models.factory import get_model  # noqa: E402
from tracknetv3_tpu_torch.ops import conv3x3 as c3  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "port_bench"))
from reference import tracknet_v1 as ref  # noqa: E402

H, W, N = 32, 64, 2
F32_REL = 1e-4
BF16_REL = 0.06  # 18 layers each rounded once to bfloat16: 0.011-0.020 over four seeds, the
# wrong order 0.33-0.60


def _model(seed=0):
    model = get_model("TrackNetV1", generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(8.0)  # keep the logits' size through 18 layers
                m.bias.uniform_(-0.1, 0.1, generator=g)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.5, 0.5, generator=g)
                m.running_mean.uniform_(0.0, 1.0, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model.eval()


def _x(seed=1):
    return torch.rand((N, 9, H, W), generator=torch.Generator().manual_seed(seed))


def _reference(model, x, relu_first=True):
    """The reference's logits, or with ``relu_first=False`` the same network
    with each BatchNorm before its ReLU (the wrong order)."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    if relu_first:
        return ref.logits(sd, x)
    for i, (_, after) in enumerate(ref.LAYERS):
        pre = f"conv{i + 1}.block."
        y = F.conv2d(x, sd[pre + "0.weight"], sd[pre + "0.bias"], padding=1)
        y = F.batch_norm(y, sd[pre + "2.running_mean"], sd[pre + "2.running_var"],
                         sd[pre + "2.weight"], sd[pre + "2.bias"], eps=tracknet_v1.EPS)
        x = torch.relu(y)
        if after == "pool":
            x = F.max_pool2d(x, 2)
        elif after == "up":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
    return x


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def test_module_matches_reference_in_float32():
    model, x = _model(), _x()
    with torch.no_grad():
        got = model(x)
        want = _reference(model, x)
    assert got.shape == (N, 256, H, W)
    assert _rel(got, want) < F32_REL
    assert float(want.abs().max()) > 1.0  # the logits kept their size


def test_module_shape_and_published_names():
    model = get_model("TrackNetV1")
    sd = model.state_dict()
    assert sum(p.numel() for p in model.parameters()) == 10_708_032
    assert sd["conv1.block.0.weight"].shape == (64, 9, 3, 3)
    assert sd["conv18.block.0.weight"].shape == (256, 64, 3, 3)
    assert "conv18.block.2.running_var" in sd and "conv19.block.0.weight" not in sd
    assert set(sd) == set(ref.BallTrackerNet().state_dict())
    w = sd["conv5.block.0.weight"]
    assert float(w.abs().max()) <= 0.05 and float(sd["conv5.block.0.bias"].abs().max()) == 0


def _fused(model, x, dtype, backend):
    params = ff.v1_fused_params(model, dtype, "cpu", backend)
    out = ff.tracknet_v1_fused_forward(params, x.permute(0, 2, 3, 1))
    return out.permute(0, 3, 1, 2)


@pytest.mark.parametrize("backend", ["cudnn", "hand_9tap", "hand_k3c"])
def test_fused_forward_matches_reference(backend):
    model, x = _model(2), _x(3)
    with torch.no_grad():
        want = _reference(model, x)
        wrong = _reference(model, x, relu_first=False)
        got32 = _fused(model, x, torch.float32, backend)
        got16 = _fused(model, x, torch.bfloat16, backend)
    assert got32.dtype == torch.float32 and got16.dtype == torch.bfloat16
    assert got16.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got32, want) < F32_REL
    assert _rel(got16, want) < BF16_REL
    # the same check against the network with the BatchNorm before the ReLU fails
    assert _rel(got32, wrong) > BF16_REL and _rel(got16, wrong) > BF16_REL


def test_fused_params_fold_the_batchnorm_after_the_relu():
    model = _model(4)
    params = ff.v1_fused_params(model, torch.float32, "cpu", "hand_9tap")
    assert params["arch"] == "TrackNetV1" and len(params["layers"]) == 18
    assert [a for *_, a in params["layers"]] == [a for _, a in tracknet_v1.LAYERS]
    bn = model.conv7.block[2]
    _, b, scale, shift, _ = params["layers"][6]
    s = bn.weight / torch.sqrt(bn.running_var + 1e-5)
    assert torch.equal(scale, s.detach()) and torch.equal(shift, (bn.bias - bn.running_mean * s)
                                                          .detach())
    assert torch.equal(b, model.conv7.block[0].bias.detach())
    # the first layer's 9 channels padded to 16 rows a tap
    assert params["layers"][0][0].shape == (3, 3 * 16, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_epilogue_mode_is_conv_relu_then_affine(dtype):
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 16, 9, 13), generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    k = torch.randn((3, 3, 16, 64), generator=g) * 0.2
    bias, scale, shift = (torch.randn(64, generator=g) for _ in range(3))
    packed = c3.pack_weights(k, dtype, device="cpu")
    got = c3.conv3x3_bias_relu(x, packed, bias, variant="9tap", scale=scale, shift=shift)
    y = F.conv2d(x.float(), packed.float().reshape(3, 3, 16, 64).permute(3, 2, 0, 1), padding=1)
    y = torch.relu(y + bias.reshape(1, -1, 1, 1))
    want = (y * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)).to(dtype)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    else:
        assert c3.bf16_ulps_apart(got, want, 0.125 * float(want.float().square().mean().sqrt())) \
            <= 1.0
    # the affine after the ReLU, not before: negative shifts survive
    assert float(got.float().min()) < 0
    # without scale and shift: the old epilogue, bit for bit
    old = torch.maximum(F.conv2d(x.float(), packed.float().reshape(3, 3, 16, 64)
                                 .permute(3, 2, 0, 1), padding=1) + bias.reshape(1, -1, 1, 1),
                        torch.zeros(()))
    assert torch.equal(c3.conv3x3_bias_relu(x, packed, bias, variant="k3c"), old.to(dtype))


def test_epilogue_mode_operand_checks():
    x = torch.zeros((1, 32, 5, 7), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    packed = torch.zeros((3, 96, 64), dtype=torch.bfloat16)
    ones = torch.ones(64)
    c3.check_kernel_input(x, packed, ones, ones, ones)
    with pytest.raises(ValueError, match="scale and shift together"):
        c3.check_kernel_input(x, packed, ones, ones, None)
    with pytest.raises(ValueError, match="float32 scale"):
        c3.check_kernel_input(x, packed, ones, ones.double(), ones)
    with pytest.raises(ValueError, match="float32 shift"):
        c3.check_kernel_input(x, packed, ones, ones, torch.ones(32))
    with pytest.raises(ValueError, match="contiguous"):
        c3.check_kernel_input(x, packed, ones, torch.ones(128)[::2], ones)


def test_class_maps_take_the_first_class_on_ties():
    logits = torch.zeros((1, 256, 2, 3))
    logits[0, 7, 0, 0] = logits[0, 200, 0, 0] = 1.0  # a tie: 7
    logits[0, 255, 0, 1] = 2.0
    logits[0, 128, 1, 2] = 1.0
    logits[0, 127, 1, 1] = 1.0
    maps = ff.class_maps(logits.contiguous(memory_format=torch.channels_last))
    want = torch.tensor([[[7, 255, 0], [0, 127, 128]]], dtype=torch.float32) / 255.0
    assert maps.dtype == torch.float32 and torch.equal(maps, want)
    # the decode's threshold: gray > 127
    assert bool(maps[0, 1, 2] > 0.5) and not bool(maps[0, 1, 1] > 0.5)
    assert torch.equal(ff.class_maps(logits.to(torch.bfloat16)), want)


def test_unet_forward_launches_and_results_unchanged(monkeypatch):
    """The U-Net's forward on a hand backend calls the conv 17 times, never
    in the ReLU -> affine mode, and gives the old epilogue's bits."""
    model = get_model("TrackNet", 3, "", generator=torch.Generator().manual_seed(6),
                      dtype=torch.float32)
    params = ff.fused_params(ff.fold_batchnorm(model), torch.bfloat16, "cpu", "hand_9tap")
    calls = []
    real = c3.conv3x3_bias_relu

    def counted(x, packed, bias=None, **kw):
        calls.append(kw)
        return real(x, packed, bias, **kw)

    def old_epilogue(x, packed, bias=None, *, variant, relu=True):
        w = packed.reshape(3, 3, -1, packed.shape[2]).permute(3, 2, 0, 1).float()
        y = F.conv2d(x.float(), w, padding=1) + bias.reshape(1, -1, 1, 1)
        y = torch.maximum(y, torch.zeros(()))
        return y.to(x.dtype).contiguous(memory_format=torch.channels_last)

    x = torch.rand((N, H, W, 9), generator=torch.Generator().manual_seed(7))
    monkeypatch.setattr(c3, "conv3x3_bias_relu", counted)
    got = ff.tracknet_fused_forward(params, x)
    assert len(calls) == 17 and all(kw.get("scale") is None for kw in calls)
    monkeypatch.setattr(c3, "conv3x3_bias_relu", old_epilogue)
    assert torch.equal(got, ff.tracknet_fused_forward(params, x))


def test_reference_window_inputs_are_newest_first_bgr():
    rgb = torch.from_numpy(np.random.default_rng(8).integers(0, 255, (6, 8, 16, 3), np.uint8))
    x = ref.window_inputs(rgb, torch.tensor([0, 3]))
    assert x.shape == (2, 9, 8, 16)
    for n, s in enumerate((0, 3)):
        for k, t in enumerate((s + 2, s + 1, s)):
            want = rgb[min(t, 5)].flip(-1).permute(2, 0, 1).float() / 255.0
            assert torch.equal(x[n, 3 * k:3 * k + 3], want)
