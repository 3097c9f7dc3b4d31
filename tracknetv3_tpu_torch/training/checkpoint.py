"""Checkpoints in the JAX package's pickle-free npz format.

One file per checkpoint (``{model_name}_best.pt`` / ``{model_name}_cur.pt``),
an npz archive holding

  - ``__meta__``: JSON (format_version, epoch, max_val_acc, param_dict,
    scheduler, n_opt_leaves);
  - ``model/params/<block>/<conv_i>/...`` and ``model/batch_stats/...``:
    TrackNet variables in the JAX package's layouts (HWIO kernels);
  - ``opt/<i>``: optimizer-state leaves in optax's flatten order for the
    same optimizer: Adam is the step count, then ``mu``, then ``nu``; SGD
    the momentum trace; Adadelta ``e_g`` then ``e_x``; a step-based
    schedule appends its own count. Per-parameter leaves follow the sorted
    JAX parameter paths (``models.convert.JAX_PARAM_PATHS``).

So the JAX package loads a port checkpoint (``load_model_from_checkpoint``,
``unflatten_optimizer_state``) and the port loads a JAX one. Files are
read with ``allow_pickle=False`` and written synchronously.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.convert import (
    PARAM_MAP,
    jax_to_torch_layout,
    torch_to_jax_layout,
    tracknet_from_jax,
    tracknet_to_jax,
)

_FORMAT_VERSION = 2
_SEP = "/"

# torch optimizer state key(s) -> optax per-parameter leaf groups, in order
_SLOTS = {
    "Adam": ("exp_avg", "exp_avg_sq"),  # optax mu, nu
    "SGD": ("momentum_buffer",),  # optax trace
    "Adadelta": ("square_avg", "acc_delta"),  # optax e_g, e_x
}


def _flatten(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _params_by_name(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    return dict(model.named_parameters())


def optimizer_to_jax_leaves(
    optimizer: torch.optim.Optimizer, model: torch.nn.Module, optim_name: str,
    step: int, scheduled: bool,
) -> List[np.ndarray]:
    """The optimizer's state as optax state leaves (JAX layouts)."""
    params = _params_by_name(model)
    count = np.asarray(step, np.int32)
    leaves: List[np.ndarray] = [count] if optim_name == "Adam" else []
    for slot in _SLOTS[optim_name]:
        for _, name in PARAM_MAP:
            p = params[name]
            buf = optimizer.state.get(p, {}).get(slot)
            arr = (
                np.zeros(tuple(p.shape), np.float32)
                if buf is None
                else buf.detach().float().cpu().numpy()
            )
            leaves.append(torch_to_jax_layout(arr))
    if scheduled:
        leaves.append(count.copy())
    return leaves


def load_optimizer_jax_leaves(
    optimizer: torch.optim.Optimizer, model: torch.nn.Module, optim_name: str,
    leaves: List[np.ndarray], step: int,
) -> None:
    """Restore optimizer state from optax leaves; ``step`` is the number of
    optimizer steps taken (the checkpoint's ``scheduler.opt_step``)."""
    params = _params_by_name(model)
    slots = _SLOTS[optim_name]
    n = len(PARAM_MAP)
    head = 1 if optim_name == "Adam" else 0
    if len(leaves) not in (head + n * len(slots), head + n * len(slots) + 1):
        raise ValueError(
            f"{optim_name} state needs {head + n * len(slots)} leaves (+1 with a "
            f"schedule), checkpoint has {len(leaves)}"
        )
    for j, slot in enumerate(slots):
        for i, (_, name) in enumerate(PARAM_MAP):
            p = params[name]
            arr = jax_to_torch_layout(np.asarray(leaves[head + j * n + i], np.float32))
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{slot} of {name}: shape {arr.shape} != {tuple(p.shape)}")
            state = optimizer.state[p]
            state[slot] = torch.from_numpy(arr.copy()).to(p.device)
            if optim_name != "SGD":
                state["step"] = torch.tensor(float(step), dtype=torch.float32)


def save_checkpoint(
    path: str,
    *,
    epoch: int,
    max_val_acc: float,
    model: torch.nn.Module,
    opt_leaves: Optional[List[np.ndarray]] = None,
    scheduler: Optional[Dict[str, Any]] = None,
    param_dict: Optional[Dict[str, Any]] = None,
) -> None:
    """Write ``model`` (+ optimizer leaves) to ``path`` atomically."""
    meta = dict(
        format_version=_FORMAT_VERSION,
        epoch=int(epoch),
        max_val_acc=float(max_val_acc),
        param_dict=dict(param_dict or {}),
        scheduler=None if scheduler is None else dict(scheduler),
        n_opt_leaves=None if opt_leaves is None else len(opt_leaves),
    )
    arrays = _flatten(tracknet_to_jax(model), "model")
    for i, leaf in enumerate(opt_leaves or []):
        arrays[f"opt{_SEP}{i}"] = np.asarray(leaf)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint of either package (npz format only)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        model_flat = {
            k[len("model") + 1 :]: z[k] for k in z.files if k.startswith(f"model{_SEP}")
        }
        optimizer = None
        if meta.get("n_opt_leaves") is not None:
            optimizer = [z[f"opt{_SEP}{i}"] for i in range(meta["n_opt_leaves"])]
    return dict(
        epoch=meta["epoch"],
        max_val_acc=meta["max_val_acc"],
        model=_unflatten(model_flat),
        optimizer=optimizer,
        scheduler=meta.get("scheduler"),
        param_dict=meta.get("param_dict", {}),
    )


def load_model_from_checkpoint(path: str, dtype: torch.dtype = torch.bfloat16):
    """Rebuild (TrackNet on the CPU, param_dict) from a checkpoint file."""
    from ..models.factory import get_model

    ckpt = load_checkpoint(path)
    pd = ckpt["param_dict"]
    model = get_model(pd.get("model_name", "TrackNet"), pd["seq_len"], pd.get("bg_mode", ""),
                      dtype=dtype)
    model.load_state_dict(tracknet_from_jax(ckpt["model"]))
    return model, pd
