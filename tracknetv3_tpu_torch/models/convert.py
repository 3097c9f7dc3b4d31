"""Model weights between the JAX package's variable trees and the port.

``tracknet_from_jax`` turns ``{"params", "batch_stats"}`` numpy trees (the
layout of the JAX package's models and checkpoints) into a state dict of
the port's ``TrackNet``; ``tracknet_to_jax`` goes the other way. 2-D conv
kernels are HWIO in JAX and OIHW here. ``inpaintnet_from_jax`` /
``inpaintnet_to_jax`` do the same for InpaintNet's ``{"params"}`` tree:
1-D conv kernels are flax ``(k, Ci, Co)`` and torch ``(Co, Ci, k)``.

``tracknet_v1_to_tree`` / ``tracknet_v1_from_tree`` keep TrackNetV1
(``models/tracknet_v1.py``, which has no JAX counterpart) in the same
checkpoint layout: ``{"params": {"conv{i}": {"conv": {"kernel" (HWIO),
"bias"}, "bn": {"scale", "bias"}}}, "batch_stats": {"conv{i}": {"bn":
{"mean", "var"}}}}``.

``JAX_PARAM_PATHS`` lists the JAX parameter paths in ``jax.tree_util``'s
flatten order (dict keys sorted at every level), which is also the order
of the per-parameter leaves of an optax optimizer state; checkpoints use
it (``PARAM_MAP``; InpaintNet's is ``INPAINT_PARAM_MAP``) to write and read
optimizer state in the JAX package's format.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

BLOCKS = (
    ("down_block_1", 2),
    ("down_block_2", 2),
    ("down_block_3", 3),
    ("bottleneck", 3),
    ("up_block_1", 3),
    ("up_block_2", 2),
    ("up_block_3", 2),
)


def _param_map() -> List[Tuple[Tuple[str, ...], str]]:
    """(JAX path, torch parameter name) for every TrackNet parameter."""
    out = []
    for block, n in BLOCKS:
        for i in range(1, n + 1):
            pre = (block, f"conv_{i}")
            tp = f"{block}.conv_{i}"
            out.append((pre + ("bn", "bias"), f"{tp}.bn.bias"))
            out.append((pre + ("bn", "scale"), f"{tp}.bn.weight"))
            out.append((pre + ("conv", "kernel"), f"{tp}.conv.weight"))
    out.append((("predictor", "bias"), "predictor.bias"))
    out.append((("predictor", "kernel"), "predictor.weight"))
    return sorted(out)


PARAM_MAP = _param_map()
JAX_PARAM_PATHS = [p for p, _ in PARAM_MAP]


def jax_to_torch_layout(a: np.ndarray) -> np.ndarray:
    """HWIO conv kernel -> OIHW; other leaves unchanged."""
    return np.ascontiguousarray(a.transpose(3, 2, 0, 1)) if a.ndim == 4 else a


def torch_to_jax_layout(a: np.ndarray) -> np.ndarray:
    """OIHW conv kernel -> HWIO; other leaves unchanged."""
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a


def _get(tree: Dict[str, Any], path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def tracknet_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` numpy trees -> port state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for path, name in PARAM_MAP:
        arr = np.asarray(_get(params, path), np.float32)
        sd[name] = torch.from_numpy(jax_to_torch_layout(arr).copy())
    for block, n in BLOCKS:
        for i in range(1, n + 1):
            bn = stats[block][f"conv_{i}"]["bn"]
            sd[f"{block}.conv_{i}.bn.running_mean"] = torch.from_numpy(
                np.array(bn["mean"], np.float32)
            )
            sd[f"{block}.conv_{i}.bn.running_var"] = torch.from_numpy(
                np.array(bn["var"], np.float32)
            )
    return sd


def tracknet_to_jax(module: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, Any]:
    """Port ``TrackNet`` (or its state dict) -> JAX ``{"params",
    "batch_stats"}`` numpy trees."""
    state = module.state_dict() if isinstance(module, torch.nn.Module) else module
    sd = {k: v.detach().cpu().numpy() for k, v in state.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for path, name in PARAM_MAP:
        _set(params, path, torch_to_jax_layout(sd[name]))
    for block, n in BLOCKS:
        for i in range(1, n + 1):
            pre = f"{block}.conv_{i}.bn"
            _set(stats, (block, f"conv_{i}", "bn", "mean"), sd[f"{pre}.running_mean"])
            _set(stats, (block, f"conv_{i}", "bn", "var"), sd[f"{pre}.running_var"])
    return {"params": params, "batch_stats": stats}


INPAINT_LAYERS = ("down_1", "down_2", "down_3", "bottleneck_1", "bottleneck_2",
                  "up_1", "up_2", "up_3")


def _inpaint_map() -> List[Tuple[Tuple[str, ...], str]]:
    """(JAX path, torch parameter name) for every InpaintNet parameter."""
    out = []
    for layer in INPAINT_LAYERS:
        out.append(((layer, "conv", "kernel"), f"{layer}.conv.weight"))
        out.append(((layer, "conv", "bias"), f"{layer}.conv.bias"))
    out.append((("predictor", "kernel"), "predictor.weight"))
    out.append((("predictor", "bias"), "predictor.bias"))
    return out


INPAINT_MAP = _inpaint_map()
# the same pairs in jax.tree_util's flatten order (sorted paths: bias before
# kernel), the order of an optax state's per-parameter leaves
INPAINT_PARAM_MAP = sorted(INPAINT_MAP)


def conv1d_to_jax_layout(a: np.ndarray) -> np.ndarray:
    """torch Conv1d kernel (Co, Ci, k) -> flax (k, Ci, Co); other leaves unchanged."""
    return np.ascontiguousarray(a.transpose(2, 1, 0)) if a.ndim == 3 else a


conv1d_to_torch_layout = conv1d_to_jax_layout  # the same axis swap, its own inverse


def inpaintnet_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX InpaintNet ``{"params"}`` numpy tree -> port state dict."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for path, name in INPAINT_MAP:
        arr = conv1d_to_torch_layout(np.asarray(_get(params, path), np.float32))
        sd[name] = torch.from_numpy(np.array(arr))  # a writable copy
    return sd


def inpaintnet_to_jax(module: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, Any]:
    """Port ``InpaintNet`` (or its state dict) -> JAX ``{"params"}`` tree."""
    state = module.state_dict() if isinstance(module, torch.nn.Module) else module
    params: Dict[str, Any] = {}
    for path, name in INPAINT_MAP:
        _set(params, path, conv1d_to_jax_layout(state[name].detach().cpu().numpy()))
    return {"params": params}


def tracknet_v1_to_tree(module: Union[torch.nn.Module, Mapping[str, torch.Tensor]]
                        ) -> Dict[str, Any]:
    """Port ``TrackNetV1`` (or a ``BallTrackerNet`` state dict) -> the
    checkpoint's ``{"params", "batch_stats"}`` numpy trees (HWIO kernels;
    BatchNorm's ``num_batches_tracked`` is not kept)."""
    state = module.state_dict() if isinstance(module, torch.nn.Module) else module
    n = sum(1 for k in state if k.endswith(".block.0.weight"))
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(1, n + 1):
        pre = f"conv{i}.block."
        sd = {k: state[pre + k].detach().float().cpu().numpy() for k in (
            "0.weight", "0.bias", "2.weight", "2.bias", "2.running_mean", "2.running_var")}
        params[f"conv{i}"] = {"conv": {"kernel": torch_to_jax_layout(sd["0.weight"]),
                                       "bias": sd["0.bias"]},
                              "bn": {"scale": sd["2.weight"], "bias": sd["2.bias"]}}
        stats[f"conv{i}"] = {"bn": {"mean": sd["2.running_mean"], "var": sd["2.running_var"]}}
    return {"params": params, "batch_stats": stats}


def tracknet_v1_from_tree(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The checkpoint's trees -> a ``TrackNetV1`` state dict (each
    ``num_batches_tracked`` 0)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    for i in range(1, len(params) + 1):
        p, s, pre = params[f"conv{i}"], stats[f"conv{i}"]["bn"], f"conv{i}.block."
        sd[pre + "0.weight"] = t(jax_to_torch_layout(np.asarray(p["conv"]["kernel"])))
        sd[pre + "0.bias"] = t(p["conv"]["bias"])
        sd[pre + "2.weight"] = t(p["bn"]["scale"])
        sd[pre + "2.bias"] = t(p["bn"]["bias"])
        sd[pre + "2.running_mean"] = t(s["mean"])
        sd[pre + "2.running_var"] = t(s["var"])
        sd[pre + "2.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return sd
