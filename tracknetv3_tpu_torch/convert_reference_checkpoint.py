"""Convert a reference (PyTorch) TrackNetV3 checkpoint to the port's format.

The port's copy of the JAX package's ``tools/convert_reference_checkpoint.py``,
which writes through that package's jax-importing checkpoint module and so
cannot run where only the port is installed:

    python -m tracknetv3_tpu_torch.convert_reference_checkpoint \\
        --in TrackNet_best.pt --out exp/TrackNet_best.pt

Reference checkpoints are ``torch.save`` dicts with ``model`` (a
state_dict), ``param_dict``, ``epoch``, ``max_val_acc`` (reference:
train.py:286-301). ``convert_tracknet`` / ``convert_inpaintnet`` map the
tensors into the JAX package's variable trees exactly as that tool does
(the same name tables, the reference's ``buttleneck`` typo included):

  Conv2d weight (Cout, Cin, kh, kw) -> kernel (kh, kw, Cin, Cout)
  Conv1d weight (Cout, Cin, k)      -> kernel (k, Cin, Cout)
  BatchNorm weight/bias             -> bn scale/bias (params)
  BatchNorm running_mean/var        -> batch_stats mean/var

Keys the trees do not hold (``nn.BatchNorm2d``'s ``num_batches_tracked``)
are not read. ``convert_checkpoint`` then builds the port's TrackNet (in
float32, its channel counts taken from the tensors) or InpaintNet, loads
the tree into it (``models.convert``) and writes it with
``training.checkpoint.save_checkpoint``: the npz file both packages read,
with the tool's ``param_dict`` (``model_name`` inferred where missing).

Host only: it reads and writes files on the CPU and does no device work, so
it runs without a card.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .config import BG_MODES, tracknet_in_channels

_TRACKNET_BLOCKS = [
    ("down_block_1", 2),
    ("down_block_2", 2),
    ("down_block_3", 3),
    ("bottleneck", 3),
    ("up_block_1", 3),
    ("up_block_2", 2),
    ("up_block_3", 2),
]

_INPAINT_LAYERS = [
    # (reference prefix, our name)
    ("down_1", "down_1"),
    ("down_2", "down_2"),
    ("down_3", "down_3"),
    ("buttleneck.conv_1", "bottleneck_1"),  # sic - reference typo
    ("buttleneck.conv_2", "bottleneck_2"),
    ("up_1", "up_1"),
    ("up_2", "up_2"),
    ("up_3", "up_3"),
]


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def convert_tracknet(state_dict) -> Dict[str, Any]:
    """Reference TrackNet state dict -> JAX ``{"params", "batch_stats"}`` tree."""
    params, stats = {}, {}
    for block, n in _TRACKNET_BLOCKS:
        params[block], stats[block] = {}, {}
        for i in range(1, n + 1):
            pre = f"{block}.conv_{i}"
            w = _np(state_dict[f"{pre}.conv.weight"])  # (Cout, Cin, kh, kw)
            params[block][f"conv_{i}"] = {
                "conv": {"kernel": w.transpose(2, 3, 1, 0)},
                "bn": {
                    "scale": _np(state_dict[f"{pre}.bn.weight"]),
                    "bias": _np(state_dict[f"{pre}.bn.bias"]),
                },
            }
            stats[block][f"conv_{i}"] = {
                "bn": {
                    "mean": _np(state_dict[f"{pre}.bn.running_mean"]),
                    "var": _np(state_dict[f"{pre}.bn.running_var"]),
                }
            }
    pw = _np(state_dict["predictor.weight"])  # (Cout, Cin, 1, 1)
    params["predictor"] = {
        "kernel": pw.transpose(2, 3, 1, 0),
        "bias": _np(state_dict["predictor.bias"]),
    }
    return {"params": params, "batch_stats": stats}


def convert_inpaintnet(state_dict) -> Dict[str, Any]:
    """Reference InpaintNet state dict -> JAX ``{"params"}`` tree. The
    reference's bottleneck convs have no ``.conv`` level (``buttleneck.conv_1.weight``)."""
    params = {}
    for ref, ours in _INPAINT_LAYERS:
        key = f"{ref}.conv" if not ref.startswith("buttleneck") else ref
        w = _np(state_dict[f"{key}.weight"])  # (Cout, Cin, k)
        params[ours] = {
            "conv": {
                "kernel": w.transpose(2, 1, 0),
                "bias": _np(state_dict[f"{key}.bias"]),
            }
        }
    pw = _np(state_dict["predictor.weight"])
    params["predictor"] = {
        "kernel": pw.transpose(2, 1, 0),
        "bias": _np(state_dict["predictor.bias"]),
    }
    return {"params": params}


def tracknet_shape(state_dict, param_dict: Dict[str, Any]):
    """(seq_len, bg_mode) of a reference TrackNet: ``seq_len`` is the
    predictor's Cout and the first conv's Cin must be
    ``tracknet_in_channels(seq_len, bg_mode)``. ``param_dict``'s ``seq_len``
    and ``bg_mode`` are checked against the tensors where present (a
    mismatch raises ``ValueError``); without ``bg_mode`` the first mode that
    fits is taken, which builds the same network."""
    cin = int(state_dict["down_block_1.conv_1.conv.weight"].shape[1])
    seq_len = int(state_dict["predictor.weight"].shape[0])
    if param_dict.get("seq_len") is not None and int(param_dict["seq_len"]) != seq_len:
        raise ValueError(f"param_dict seq_len {param_dict['seq_len']} != the predictor's "
                         f"{seq_len} output channels")
    modes = [param_dict["bg_mode"]] if param_dict.get("bg_mode") is not None else BG_MODES
    fits = [m for m in modes if tracknet_in_channels(seq_len, m) == cin]
    if not fits:
        raise ValueError(f"the first conv's {cin} input channels fit no bg_mode of "
                         f"{list(modes)} at seq_len {seq_len}")
    return seq_len, fits[0]


def convert_checkpoint(in_path: str, out_path: str) -> None:
    import torch

    from .models.convert import inpaintnet_from_jax, tracknet_from_jax
    from .models.factory import get_model
    from .training.checkpoint import save_checkpoint

    ckpt = torch.load(in_path, map_location="cpu", weights_only=False)
    pd = dict(ckpt.get("param_dict", {}))
    model_name = pd.get("model_name") or (
        "TrackNet" if any("down_block" in k for k in ckpt["model"]) else "InpaintNet"
    )
    pd.setdefault("model_name", model_name)
    if model_name == "TrackNet":
        seq_len, bg_mode = tracknet_shape(ckpt["model"], pd)
        # float32: a bfloat16 module would round every weight it is given
        model = get_model("TrackNet", seq_len, bg_mode, dtype=torch.float32)
        model.load_state_dict(tracknet_from_jax(convert_tracknet(ckpt["model"])))
    else:
        model = get_model("InpaintNet")
        model.load_state_dict(inpaintnet_from_jax(convert_inpaintnet(ckpt["model"])))

    save_checkpoint(
        out_path,
        epoch=int(ckpt.get("epoch", 0)),
        max_val_acc=float(ckpt.get("max_val_acc", 0.0)),
        model=model,
        param_dict=pd,
    )
    print(f"Converted {model_name} checkpoint -> {out_path}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in", dest="in_path", required=True, help="reference .pt file")
    ap.add_argument("--out", dest="out_path", required=True, help="output checkpoint")
    args = ap.parse_args(argv)
    convert_checkpoint(args.in_path, args.out_path)


if __name__ == "__main__":
    main()
