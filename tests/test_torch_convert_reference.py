"""The port's reference-checkpoint converter
(``python -m tracknetv3_tpu_torch.convert_reference_checkpoint``) against the
JAX package's ``tools/convert_reference_checkpoint.py``.

Random reference-layout checkpoints at full channel widths (TrackNet at
seq_len 8 with bg_mode concat, so 27 input channels, He-scaled so that the
activations stay O(1) through the 17 layers; InpaintNet), with the
``num_batches_tracked`` buffers ``nn.BatchNorm2d`` adds, saved as the
reference saves them. Both tools convert each file:

- the two npz files hold the same keys and the same float32 arrays bit for
  bit, and the same metadata;
- each package loads the other's file;
- the port's float32 forwards on the converted weights (the module in eval
  mode and the folded serving forward for TrackNet, the module for
  InpaintNet) match the independent ``torch.nn.functional`` forwards of the
  reference architecture within 2e-5 at 32x64;
- ``model_name`` is inferred where ``param_dict`` lacks it, and a
  ``param_dict`` that contradicts the tensors raises;
- the CLI runs in a process where ``jax`` and the JAX package cannot be
  imported.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share a few cores

import torch.nn.functional as F  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import convert_reference_checkpoint as jax_tool  # noqa: E402
from test_convert_checkpoint import _torch_tracknet_forward  # noqa: E402
from tracknetv3_tpu.training import checkpoint as jax_ckpt  # noqa: E402
from tracknetv3_tpu_torch import convert_reference_checkpoint as port_tool  # noqa: E402
from tracknetv3_tpu_torch.models.fused_forward import (  # noqa: E402
    fold_batchnorm,
    fused_params,
    tracknet_fused_forward,
)
from tracknetv3_tpu_torch.training import checkpoint as port_ckpt  # noqa: E402

SEQ, IN_DIM = 8, 27  # bg_mode concat: (seq_len + 1) * 3 channels
HW = (32, 64)
TRACKNET_CHANS = {
    "down_block_1": (IN_DIM, 64),
    "down_block_2": (64, 128),
    "down_block_3": (128, 256),
    "bottleneck": (256, 512),
    "up_block_1": (768, 256),
    "up_block_2": (384, 128),
    "up_block_3": (192, 64),
}
INPAINT_CHANS = {
    "down_1": (3, 32),
    "down_2": (32, 64),
    "down_3": (64, 128),
    "buttleneck.conv_1": (128, 256),
    "buttleneck.conv_2": (256, 256),
    "up_1": (384, 128),
    "up_2": (192, 64),
    "up_3": (96, 32),
}


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def reference_tracknet_state_dict(rng):
    """A reference TrackNet state dict: He-scaled conv weights, BatchNorm
    affine parameters and running statistics, ``num_batches_tracked``."""
    sd = {}
    for block, n in port_tool._TRACKNET_BLOCKS:
        cin, cout = TRACKNET_CHANS[block]
        for i in range(1, n + 1):
            c_in = cin if i == 1 else cout
            pre = f"{block}.conv_{i}"
            sd[f"{pre}.conv.weight"] = _t(rng.normal(0, np.sqrt(2 / (9 * c_in)),
                                                     (cout, c_in, 3, 3)))
            sd[f"{pre}.bn.weight"] = _t(rng.uniform(0.5, 1.5, cout))
            sd[f"{pre}.bn.bias"] = _t(rng.normal(0, 0.1, cout))
            sd[f"{pre}.bn.running_mean"] = _t(rng.normal(0, 0.1, cout))
            sd[f"{pre}.bn.running_var"] = _t(rng.uniform(0.5, 1.5, cout))
            sd[f"{pre}.bn.num_batches_tracked"] = torch.tensor(1234)
    sd["predictor.weight"] = _t(rng.normal(0, np.sqrt(2 / 64), (SEQ, 64, 1, 1)))
    sd["predictor.bias"] = _t(rng.normal(0, 0.1, SEQ))
    return sd


def _inpaint_key(ref):
    return f"{ref}.conv" if not ref.startswith("buttleneck") else ref


def reference_inpaintnet_state_dict(rng):
    sd = {}
    for ref, _ in port_tool._INPAINT_LAYERS:
        cin, cout = INPAINT_CHANS[ref]
        sd[f"{_inpaint_key(ref)}.weight"] = _t(rng.normal(0, 0.2, (cout, cin, 3)))
        sd[f"{_inpaint_key(ref)}.bias"] = _t(rng.normal(0, 0.1, cout))
    sd["predictor.weight"] = _t(rng.normal(0, 0.2, (2, 32, 3)))
    sd["predictor.bias"] = _t(rng.normal(0, 0.1, 2))
    return sd


def reference_inpaintnet_forward(sd, coords, mask):
    """Independent ``torch.nn.functional`` statement of InpaintNet."""

    def block(x, ref):
        k = _inpaint_key(ref)
        return F.leaky_relu(F.conv1d(x, sd[f"{k}.weight"], sd[f"{k}.bias"], padding="same"), 0.01)

    x = torch.cat([coords, mask], -1).transpose(1, 2)
    x1 = block(x, "down_1")
    x2 = block(x1, "down_2")
    x3 = block(x2, "down_3")
    x = block(block(x3, "buttleneck.conv_1"), "buttleneck.conv_2")
    x = block(torch.cat([x, x3], 1), "up_1")
    x = block(torch.cat([x, x2], 1), "up_2")
    x = block(torch.cat([x, x1], 1), "up_3")
    x = F.conv1d(x, sd["predictor.weight"], sd["predictor.bias"], padding="same")
    return torch.sigmoid(x).transpose(1, 2)


def _save_reference(path, sd, param_dict):
    torch.save({"model": sd, "param_dict": param_dict, "epoch": 17, "max_val_acc": 0.8125},
               str(path))
    return str(path)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    d = tmp_path_factory.mktemp("reference")
    tn_sd = reference_tracknet_state_dict(np.random.default_rng(0))
    inp_sd = reference_inpaintnet_state_dict(np.random.default_rng(1))
    tn_pd = {"model_name": "TrackNet", "seq_len": SEQ, "bg_mode": "concat", "epochs": 30,
             "batch_size": 10, "alpha": 0.5}
    inp_pd = {"model_name": "InpaintNet", "seq_len": 16, "mask_ratio": 0.3}
    out = {}
    for name, sd, pd in (("TrackNet", tn_sd, tn_pd), ("InpaintNet", inp_sd, inp_pd)):
        src = _save_reference(d / f"{name}_ref.pt", sd, pd)
        jax_out, port_out = str(d / f"{name}_jax.pt"), str(d / f"{name}_port.pt")
        jax_tool.convert_checkpoint(src, jax_out)
        port_tool.convert_checkpoint(src, port_out)
        out[name] = dict(sd=sd, src=src, jax=jax_out, port=port_out)
    yield out
    shutil.rmtree(d, ignore_errors=True)  # its TrackNet checkpoints, 45 MB or more each


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each test's checkpoints and save_dir (a full-width TrackNet checkpoint
    is 130 MB whatever input_hw) go once the test has read them."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("name", ["TrackNet", "InpaintNet"])
def test_npz_equals_the_jax_tools_array_for_array(refs, name):
    got, want = _npz(refs[name]["port"]), _npz(refs[name]["jax"])
    assert sorted(got) == sorted(want)
    n_model = 0
    for k in want:
        if k == "__meta__":
            continue
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        assert np.ascontiguousarray(got[k]).tobytes() == np.ascontiguousarray(want[k]).tobytes(), k
        n_model += 1
    assert n_model == (17 * 5 + 2 if name == "TrackNet" else 18)
    meta_got = json.loads(bytes(got["__meta__"]).decode())
    meta_want = json.loads(bytes(want["__meta__"]).decode())
    assert meta_got == meta_want
    assert (meta_got["epoch"], meta_got["max_val_acc"]) == (17, 0.8125)


@pytest.mark.parametrize("name", ["TrackNet", "InpaintNet"])
def test_each_package_loads_the_others_file(refs, name):
    from_port = jax_ckpt.load_checkpoint(refs[name]["port"])
    from_jax = port_ckpt.load_checkpoint(refs[name]["jax"])
    for a, b in ((from_port, port_ckpt.load_checkpoint(refs[name]["port"])),
                 (from_jax, jax_ckpt.load_checkpoint(refs[name]["jax"]))):
        assert (a["epoch"], a["max_val_acc"], a["param_dict"]) == (
            b["epoch"], b["max_val_acc"], b["param_dict"])
        np.testing.assert_equal(a["model"]["params"], b["model"]["params"])
    # the JAX package rebuilds its module from the port's file (a tree check)
    _, variables, pd = jax_ckpt.load_model_from_checkpoint(refs[name]["port"])
    assert pd["model_name"] == name
    port_model, _ = port_ckpt.load_model_from_checkpoint(refs[name]["jax"], dtype=torch.float32)
    assert sum(p.numel() for p in port_model.parameters()) == sum(
        np.asarray(v).size for v in jax_flat(variables["params"]))


def jax_flat(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from jax_flat(v)
        else:
            yield v


def test_tracknet_forward_matches_the_reference_forward(refs):
    sd = refs["TrackNet"]["sd"]
    x = torch.tensor(np.random.default_rng(2).uniform(0, 1, (2, IN_DIM) + HW).astype(np.float32))
    want = _torch_tracknet_forward(sd, x)
    # not a comparison of saturated sigmoids
    assert float(((want > 0.01) & (want < 0.99)).float().mean()) > 0.8
    model, pd = port_ckpt.load_model_from_checkpoint(refs["TrackNet"]["port"], dtype=torch.float32)
    assert (pd["seq_len"], pd["bg_mode"]) == (SEQ, "concat")
    with torch.no_grad():
        got = torch.sigmoid(model.eval()(x))
        params = fused_params(fold_batchnorm(model), torch.float32, "cpu", "cudnn")
        served = tracknet_fused_forward(params, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(served.numpy(), want.numpy(), atol=2e-5, rtol=0)


def test_inpaintnet_forward_matches_the_reference_forward(refs):
    sd = refs["InpaintNet"]["sd"]
    rng = np.random.default_rng(3)
    coords = torch.tensor(rng.uniform(0, 1, (2, 16, 2)).astype(np.float32))
    mask = torch.tensor((rng.uniform(0, 1, (2, 16, 1)) > 0.5).astype(np.float32))
    want = reference_inpaintnet_forward(sd, coords, mask)
    model, pd = port_ckpt.load_model_from_checkpoint(refs["InpaintNet"]["port"])
    assert pd == {"model_name": "InpaintNet", "seq_len": 16, "mask_ratio": 0.3}
    with torch.no_grad():
        got = model.eval()(coords, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["TrackNet", "InpaintNet"])
def test_model_name_is_inferred_without_a_param_dict_entry(refs, tmp_path, name):
    src = _save_reference(tmp_path / "ref.pt", refs[name]["sd"], {"seq_len": SEQ}
                          if name == "TrackNet" else {})
    port_out, jax_out = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    port_tool.convert_checkpoint(src, port_out)
    jax_tool.convert_checkpoint(src, jax_out)
    got = port_ckpt.load_checkpoint(port_out)["param_dict"]
    assert got == jax_ckpt.load_checkpoint(jax_out)["param_dict"]
    assert got["model_name"] == name


@pytest.mark.parametrize("param_dict,match", [
    ({"model_name": "TrackNet", "seq_len": 3, "bg_mode": "concat"}, "seq_len 3"),
    ({"model_name": "TrackNet", "seq_len": SEQ, "bg_mode": ""}, "27 input channels"),
])
def test_a_param_dict_that_contradicts_the_tensors_raises(refs, tmp_path, param_dict, match):
    src = _save_reference(tmp_path / "ref.pt", refs["TrackNet"]["sd"], param_dict)
    with pytest.raises(ValueError, match=match):
        port_tool.convert_checkpoint(src, str(tmp_path / "out.pt"))
    assert not os.path.exists(tmp_path / "out.pt")


def test_bg_mode_is_taken_from_the_channels_without_a_param_dict(refs):
    sd = refs["TrackNet"]["sd"]
    assert port_tool.tracknet_shape(sd, {}) == (SEQ, "concat")
    first = sd["down_block_1.conv_1.conv.weight"]
    for cin, mode in ((SEQ * 3, ""), (SEQ, "subtract"), (SEQ * 4, "subtract_concat")):
        shaped = dict(sd, **{"down_block_1.conv_1.conv.weight": first[:, :1].expand(-1, cin, -1,
                                                                                     -1)})
        assert port_tool.tracknet_shape(shaped, {}) == (SEQ, mode)


def test_cli_runs_without_jax(refs, tmp_path):
    out = str(tmp_path / "cli.pt")
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['tracknetv3_tpu'] = None\n"
            "sys.argv = ['convert_reference_checkpoint', '--in', sys.argv[1], '--out', "
            "sys.argv[2]]\n"
            "runpy.run_module('tracknetv3_tpu_torch.convert_reference_checkpoint', "
            "run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.startswith(('jax.', 'tracknetv3_tpu.'))]\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, refs["TrackNet"]["src"], out], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"Converted TrackNet checkpoint -> {out}" in proc.stdout
    got, want = _npz(out), _npz(refs["TrackNet"]["jax"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
