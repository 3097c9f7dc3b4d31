"""Batches, models and step runners shared by the data-parallel training
tests (``tests/test_torch_dp_*.py``): TrackNet at 32x64, seq_len 3,
bg_mode concat and InpaintNet at seq_len 3, float64 unless a test says
otherwise, on CPU meshes of W entries (``make_mesh(W, device="cpu")``).

``tracknet_batch(kind, B, seed)`` makes a numpy batch of each kind the train
step takes: ``plain``, ``segmented`` (segments of ``SEG`` windows),
``resident`` (frame indices into one buffer), ``resident_shard`` (the same
batch, whose buffer ``run_tracknet`` shards over the mesh's entries as the
resident loader's ``frame_sharding="shard"`` does: ``shard_resident``) and
``frame_mixup``.
``run_tracknet`` / ``run_inpaintnet`` take one Adam step of the port from
given weights, on one device (``shares=None``) or over a W-entry mesh, and
return the loss, every gradient, the running statistics and the updated
parameters as numpy arrays; ``assert_close`` holds two such results to a
relative bound.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tracknetv3_tpu_torch.data.dataset import _rows_into
from tracknetv3_tpu_torch.models.factory import get_model
from tracknetv3_tpu_torch.parallel.mesh import FrameShards, make_mesh, shard_train_batch
from tracknetv3_tpu_torch.training import optim, steps

SEQ, BG, HGT, WDT = 3, "concat", 32, 64
SEG = 2  # windows a segment
T_RES, R_RES = 11, 3  # frames and rallies of a resident buffer


def _cxcy(rng, B):
    return np.stack([rng.integers(1, WDT - 1, (B, SEQ)), rng.integers(1, HGT - 1, (B, SEQ))],
                    -1).astype(np.int32)


def tracknet_batch(kind: str, B: int = 4, seed: int = 0,
                   exact_blend: bool = False) -> Dict[str, np.ndarray]:
    """``exact_blend``: frame mixup's pixel weights in quarters, so that
    both products of the blend ``fa * w + fb * (1 - w)`` are exact in
    float32 and a fused multiply-add gives the same sum."""
    rng = np.random.default_rng(seed)
    b = {"cxcy": _cxcy(rng, B), "id": np.zeros((B, SEQ, 2), np.int32)}
    if kind in ("plain", "frame_mixup"):
        b["rgb"] = rng.integers(0, 256, (B, SEQ, HGT, WDT, 3), dtype=np.uint8)
        b["median"] = rng.integers(0, 256, (B, HGT, WDT, 3), dtype=np.uint8)
    if kind == "frame_mixup":
        b["mix_pair"] = rng.integers(0, SEQ, (B, SEQ, 2)).astype(np.int32)
        b["mix_pix_w"] = rng.random((B, SEQ)).astype(np.float32)
        if exact_blend:
            b["mix_pix_w"] = np.round(b["mix_pix_w"] * 4) / 4
        b["mix_centers"] = np.stack([rng.integers(0, WDT, (B, SEQ, 2)),
                                     rng.integers(0, HGT, (B, SEQ, 2))], -1).astype(np.int32)
        b["mix_hm_w"] = rng.random((B, SEQ)).astype(np.float32)
    elif kind == "segmented":
        n_seg = B // SEG
        b["seg_rgb"] = rng.integers(0, 256, (n_seg, SEG + SEQ - 1, HGT, WDT, 3), dtype=np.uint8)
        b["median"] = rng.integers(0, 256, (n_seg, HGT, WDT, 3), dtype=np.uint8)
    elif kind in ("resident", "resident_shard"):
        b["res_idx"] = rng.integers(0, T_RES, (B, SEQ)).astype(np.int32)
        b["res_rgb_buf"] = rng.integers(0, 256, (T_RES, HGT, WDT, 3), dtype=np.uint8)
        b["res_median_buf"] = rng.integers(0, 256, (R_RES, HGT, WDT, 3)).astype(np.float32)
        b["res_median_idx"] = rng.integers(0, R_RES, B).astype(np.int32)
    elif kind != "plain":
        raise ValueError(kind)
    return b


def inpaintnet_batch(B: int = 4, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    coor = rng.uniform(0, 1, (B, SEQ, 2)).astype(np.float32)
    vis = (rng.random((B, SEQ, 1)) < 0.8).astype(np.float32)
    pred = (coor + rng.normal(0, 0.05, coor.shape)).astype(np.float32)
    return {"coor": coor, "coor_pred": pred, "vis": vis}


def crossing_mixup(B: int, seed: int = 0):
    """(perm, lam) of a global batch of B in which every row's partner lies
    in another share, for 2 or more equal shares."""
    rng = np.random.default_rng(seed)
    perm = (np.arange(B) + B // 2) % B
    lam = np.maximum(rng.uniform(0, 1, B), 0.5).astype(np.float32)
    return perm.astype(np.int64), lam


def tensors(batch) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def tracknet_model(seed: int = 1, dtype=torch.float64, state=None) -> torch.nn.Module:
    model = get_model("TrackNet", SEQ, BG, generator=torch.Generator().manual_seed(seed),
                      dtype=dtype)
    if state is not None:
        model.load_state_dict(state)
    model = model.to(torch.promote_types(dtype, torch.float32))
    model.dtype = dtype
    return model


def inpaintnet_model(seed: int = 2, dtype=torch.float64) -> torch.nn.Module:
    return get_model("InpaintNet", generator=torch.Generator().manual_seed(seed)).to(dtype)


def _result(model, loss) -> Dict:
    return {"loss": np.asarray(float(loss)),
            **{f"grad:{k}": p.grad.detach().numpy().copy()
               for k, p in model.named_parameters()},
            **{f"param:{k}": p.detach().numpy().copy() for k, p in model.named_parameters()},
            **{f"stat:{k}": v.detach().numpy().copy() for k, v in model.named_buffers()}}


def shard_resident(batch: Dict, holders: int) -> Dict:
    """A resident batch's frame buffer as the resident loader shards it over
    ``holders`` mesh entries: padded to a multiple of them by repeating its
    last row, a tuple of the entries' R rows each, and ``res_shards`` with the
    global batch's rows (the tensors on the CPU)."""
    buf = batch["res_rgb_buf"]
    R = -(-len(buf) // holders)
    shards = []
    for j in range(holders):
        out = np.empty((R,) + buf.shape[1:], buf.dtype)
        _rows_into([buf], j * R, (j + 1) * R, out)
        shards.append(torch.from_numpy(out))
    return {**tensors({k: v for k, v in batch.items() if k != "res_rgb_buf"}),
            "res_rgb_buf": tuple(shards),
            "res_shards": FrameShards(np.asarray(batch["res_idx"]), R, holders)}


def run_tracknet(model, batch, shares: Optional[int] = None, alpha: float = 0.0, perm=None,
                 lam=None, shard: bool = False) -> Dict:
    """One Adam step (lr 1e-3) of ``model`` on ``batch`` (numpy), on one
    device or over a ``shares``-entry CPU mesh (``shard``: a resident
    batch's buffer sharded over the entries, ``shard_resident``); ``perm`` /
    ``lam`` (numpy) are the global batch's."""
    opt, schedule = optim.build_optimizer("Adam", model.parameters(), 1e-3)
    tb = shard_resident(batch, shares) if shard else tensors(batch)
    if shares is None:
        step = steps.make_tracknet_train_step(model, opt, BG, alpha, schedule)
        mix = () if alpha <= 0 else (torch.from_numpy(perm), torch.from_numpy(lam))
        loss = step(tb, 0, *mix)
    else:
        mesh = make_mesh(shares, device="cpu")
        step = steps.make_tracknet_shares_train_step(model, opt, BG, alpha, schedule, mesh=mesh)
        loss = step(shard_train_batch(tb, mesh), 0, perm, lam)
    return _result(model, loss)


def run_inpaintnet(model, batch, mask, shares: Optional[int] = None,
                   clip_norm: float = 1.0) -> Dict:
    """One Adam step (lr 1e-3, gradients clipped to a global norm of
    ``clip_norm``) with the global batch's Bernoulli ``mask`` (numpy)."""
    opt, schedule = optim.build_optimizer("Adam", model.parameters(), 1e-3, clip_norm=clip_norm)
    tb = tensors(batch)
    if shares is None:
        step = steps.make_inpaintnet_train_step(model, opt, schedule)
        loss = step(tb, 0, torch.from_numpy(mask))
    else:
        mesh = make_mesh(shares, device="cpu")
        step = steps.make_inpaintnet_shares_train_step(model, opt, schedule, mesh=mesh)
        loss = step(shard_train_batch(tb, mesh), 0, mask)
    return _result(model, loss)


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """Relative L2 error (the norm of ``want`` floored at 1e-30)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def worst(got: Dict, want: Dict) -> Dict[str, float]:
    """The largest relative L2 error of each kind of entry (loss, grad,
    param, stat) and the entry it is at."""
    out: Dict = {}
    for k in want:
        kind = k.split(":")[0]
        e = rel_err(got[k], want[k])
        if e >= out.get(kind, (-1.0, ""))[0]:
            out[kind] = (e, k)
    return out


def assert_close(got: Dict, want: Dict, bound: float) -> None:
    for kind, (e, k) in worst(got, want).items():
        assert e <= bound, (kind, k, e)
