"""The JAX package's sharded train steps for the data-parallel tests
(``tests/test_torch_dp_jax_*.py``), run as its own tests run them: on the
conftest's virtual CPU devices, ``make_mesh(W)``, the state replicated
(``replicate_tree``) and the batch sharded (``shard_batch``; a resident
batch's split buffers placed as its loader places them: replicated, or
under ``frame_sharding="shard"`` the frame buffer padded to a multiple of W
by repeating its last row and split over the mesh, ``P("data")``), in
float64, the loss on materialised labels (``pallas_loss=False``).

The step's gradient is read from the Adam state it returns: after one step
``mu = (1 - b1) * g``. Results come back in the port's names
(``torch_dp_data``'s ``loss`` / ``grad:`` / ``param:`` / ``stat:`` keys),
with the ``perm`` / ``lam`` or mask that the step draws from its key, for
the port to take. ``failures`` holds a port result to the bounds that
``tests/test_torch_steps.py`` holds the one-device step to.
"""

from __future__ import annotations

from typing import Dict, List
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_dp_data import BG, SEQ
from tracknetv3_tpu.models import get_model as jax_get_model
from tracknetv3_tpu.models.inpaintnet import InpaintNet as JaxInpaintNet
from tracknetv3_tpu.parallel.mesh import make_mesh, replicate_tree, replicated, shard_batch
from tracknetv3_tpu.training import optim as jax_optim
from tracknetv3_tpu.training import steps as jax_steps
from tracknetv3_tpu_torch.models.convert import (
    BLOCKS,
    INPAINT_MAP,
    PARAM_MAP,
    _get,
    conv1d_to_torch_layout,
    inpaintnet_from_jax,
    jax_to_torch_layout,
    tracknet_from_jax,
)
from tracknetv3_tpu_torch.models.factory import get_model

B1 = 0.9  # Adam's


def tracknet_init(seed: int = 1):
    _, variables = jax_get_model("TrackNet", SEQ, BG, rng=jax.random.PRNGKey(seed),
                                 compute_dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, variables)


def inpaintnet_init(seed: int = 5):
    _, variables = jax_get_model("InpaintNet", SEQ, rng=jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, variables)


def port_tracknet(variables) -> torch.nn.Module:
    model = get_model("TrackNet", SEQ, BG, dtype=torch.float64)
    model.load_state_dict(tracknet_from_jax(variables))
    return model.double()


def port_inpaintnet(variables) -> torch.nn.Module:
    model = get_model("InpaintNet")
    model.load_state_dict(inpaintnet_from_jax({"params": variables["params"]}))
    return model.double()


def _adam_mu(opt_state):
    """The first moment of the (last) Adam state in an optax state."""
    found = [s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    return found[-1]


def _in_port_names(tracknet: bool, loss, grads, params, stats) -> Dict:
    """A JAX step's results under the port's names and layouts, in float64
    (the converters of ``models/convert.py`` round to float32)."""
    names, layout = ((PARAM_MAP, jax_to_torch_layout) if tracknet
                     else (INPAINT_MAP, conv1d_to_torch_layout))
    out = {"loss": np.asarray(float(loss))}
    for path, name in names:
        out[f"grad:{name}"] = layout(np.asarray(_get(grads, path), np.float64))
        out[f"param:{name}"] = layout(np.asarray(_get(params, path), np.float64))
    if tracknet:
        for block, n in BLOCKS:
            for i in range(1, n + 1):
                bn = stats[block][f"conv_{i}"]["bn"]
                for key, stat in (("mean", "running_mean"), ("var", "running_var")):
                    out[f"stat:{block}.conv_{i}.bn.{stat}"] = np.asarray(bn[key], np.float64)
    return out


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def place_buffer(buf: np.ndarray, mesh, shard: bool):
    """A resident split buffer on ``mesh`` as the JAX loader places it:
    replicated, or (``shard``) padded as its ``cat_pad`` pads it and split
    along axis 0."""
    from jax.sharding import NamedSharding, PartitionSpec

    if not shard:
        return jax.device_put(buf, replicated(mesh))
    extra = -len(buf) % mesh.size
    buf = np.concatenate([buf, np.repeat(buf[-1:], extra, 0)]) if extra else buf
    return jax.device_put(buf, NamedSharding(mesh, PartitionSpec("data")))


def tracknet_sharded_step(variables, batch: Dict[str, np.ndarray], W: int, alpha: float,
                          key_seed: int = 0, frame_sharding: str = "replicate"):
    """One Adam step (lr 1e-3) of the JAX step over ``make_mesh(W)``; returns
    (result, perm, lam), perm / lam the global ones it drew (or None).
    ``frame_sharding``: the placement of a resident batch's frame buffer."""
    key = jax.random.PRNGKey(key_seed)
    with jax.enable_x64(True):
        mesh = make_mesh(W)
        tx = jax_optim.build_optimizer("Adam", 1e-3)
        state = jax_steps.create_train_state(_f64(variables), tx)
        state = jax_steps.TrainState(*replicate_tree(tuple(state), mesh))
        jb = {k: (place_buffer(v, mesh, frame_sharding == "shard" and k != "res_median_buf")
                  if k.endswith("_buf") else v) for k, v in batch.items()}
        perm = lam = None
        if alpha > 0:
            x = jax_steps.assemble_tracknet_inputs({k: jnp.asarray(v) for k, v in batch.items()},
                                                   BG)
            _, perm, lam = jax_steps.sample_mixup_inputs(key, x, alpha)
            perm, lam = np.array(perm, np.int64), np.array(lam)
        step = jax_steps.make_tracknet_train_step(tx, BG, alpha=alpha, pallas_loss=False,
                                                  dtype=jnp.float64, split_up_entry=False)
        new, loss = step(state, shard_batch(jb, mesh), key)
        mu = jax.tree_util.tree_map(lambda a: np.asarray(a) / (1.0 - B1), _adam_mu(new.opt_state))
        res = _in_port_names(True, loss, mu,
                             jax.tree_util.tree_map(np.asarray, new.params),
                             jax.tree_util.tree_map(np.asarray, new.batch_stats))
    return res, perm, lam


def inpaintnet_sharded_step(variables, batch: Dict[str, np.ndarray], W: int,
                            mask_ratio: float = 0.3, key_seed: int = 3):
    """One Adam step (lr 1e-3, clipped at 1.0) of the JAX InpaintNet step
    over ``make_mesh(W)`` in float64 (the package's float32 casts pointed
    at float64 while it traces); returns (result, mask), the global mask it
    drew."""
    key = jax.random.PRNGKey(key_seed)
    with jax.enable_x64(True), mock.patch.object(jnp, "float32", jnp.float64):
        mesh = make_mesh(W)
        model = JaxInpaintNet(dtype=jnp.float64)
        tx = jax_optim.build_optimizer("Adam", 1e-3, clip_norm=1.0)
        state = jax_steps.create_train_state({"params": _f64(variables["params"])}, tx)
        state = jax_steps.TrainState(*replicate_tree(tuple(state), mesh))
        jb = {k: np.asarray(v, np.float64) for k, v in batch.items()}
        mask = np.asarray(jax.random.bernoulli(key, mask_ratio, jb["vis"].shape), np.float64)
        step = jax_steps.make_inpaintnet_train_step(model, tx, mask_ratio)
        new, loss = step(state, shard_batch(jb, mesh), key)
        mu = jax.tree_util.tree_map(lambda a: np.asarray(a) / (1.0 - B1), _adam_mu(new.opt_state))
        res = _in_port_names(False, loss, mu,
                             jax.tree_util.tree_map(np.asarray, new.params), {})
    return res, mask


def failures(got: Dict, want: Dict) -> List[str]:
    """Where a port result misses ``tests/test_torch_steps.py``'s float64
    bounds against a JAX result: loss rtol 1e-5, each gradient within
    relative L2 1e-4, running statistics atol 1e-5, updated parameters atol
    1e-6 where |g| > 1e-6 (Adam's first step follows sign(g))."""
    out = []
    if abs(float(got["loss"]) - float(want["loss"])) > 1e-5 * abs(float(want["loss"])):
        out.append("loss")
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        if k.startswith("grad:"):
            if np.linalg.norm(g - w) > 1e-4 * max(np.linalg.norm(w), 1e-30):
                out.append(k)
        elif k.startswith("stat:"):
            if np.abs(g - w).max() > 1e-5:
                out.append(k)
        elif k.startswith("param:"):
            big = np.abs(want["grad:" + k[6:]]) > 1e-6
            if np.abs(g - w)[big].max(initial=0.0) > 1e-6:
                out.append(k)
    return out
