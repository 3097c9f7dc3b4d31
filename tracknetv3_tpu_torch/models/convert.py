"""TrackNet weights between the JAX package's variable trees and the port.

``tracknet_from_jax`` turns ``{"params", "batch_stats"}`` numpy trees (the
layout of the JAX package's models and checkpoints) into a state dict of
the port's ``TrackNet``; ``tracknet_to_jax`` goes the other way. 2-D conv
kernels are HWIO in JAX and OIHW here.

``JAX_PARAM_PATHS`` lists the JAX parameter paths in ``jax.tree_util``'s
flatten order (dict keys sorted at every level), which is also the order
of the per-parameter leaves of an optax optimizer state; checkpoints use
it to write and read optimizer state in the JAX package's format.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

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


def tracknet_to_jax(module: torch.nn.Module) -> Dict[str, Any]:
    """Port ``TrackNet`` -> JAX ``{"params", "batch_stats"}`` numpy trees."""
    sd = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
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
