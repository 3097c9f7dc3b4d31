"""The caller's ``torch.distributed`` process group, as the multi-process
paths of the port read it: rally evaluation (``RallyTestEngine.test``) and
the validation loops (``evaluation/loops.py``) merge their results on the
host over ``host_group()``; data-parallel training reduces its BatchNorm
sums and gradients, gathers its mixup partners and exchanges the rows of
sharded resident frames over ``device_group()``:
NCCL where the default group is NCCL and each rank has its own card, else
gloo on host copies (ranks that share a card or run on the CPU: NCCL runs
no two ranks on one card). ``init_from_env`` joins the group that
``torchrun`` describes (``train --multihost``).
"""

from __future__ import annotations

import os
from typing import Any, List, NamedTuple, Tuple

import numpy as np

from .mesh import Exchange, Reducer, upload_indices

_GLOO = None  # (default process group, its gloo twin): host_group


def process_count_index() -> Tuple[int, int]:
    """(world size, rank) of the initialised default process group, else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def init_from_env(device: str = "cuda"):
    """Join the process group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) unless one
    is initialised already, and return this process's device: the card
    ``cuda:LOCAL_RANK`` (made current; NCCL), or the CPU (gloo). The
    counterpart of ``jax.distributed.initialize()``."""
    import torch
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", "0"))
    if torch.device(device).type == "cuda":
        if local >= torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK {local} has no card: {torch.cuda.device_count()} "
                             "visible")
        dev, backend = torch.device("cuda", local), "nccl"
        torch.cuda.set_device(dev)
    else:
        dev, backend = torch.device("cpu"), "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return dev


def host_group():
    """The process group that gathers host tensors: None (the default group)
    where the default backend includes gloo, else a gloo group over the same
    ranks, made once per default group (NCCL gathers no host tensors and runs
    no two ranks on one card). Every rank must call it at the same point, as
    ``new_group`` is collective."""
    import torch.distributed as dist

    global _GLOO
    if "gloo" in str(dist.get_backend()):
        return None
    world = dist.group.WORLD
    if _GLOO is None or _GLOO[0] is not world:
        _GLOO = (world, dist.new_group(backend="gloo"))
    return _GLOO[1]


class DeviceGroup(NamedTuple):
    """The group over which the ranks reduce and gather device tensors;
    ``host``: through host copies (gloo)."""

    group: Any
    size: int
    rank: int
    host: bool

    def all_reduce_(self, t):
        """Sum ``t`` over the ranks, in place; every rank gets the same bits."""
        import torch.distributed as dist

        if self.host and t.device.type != "cpu":
            h = t.cpu()
            dist.all_reduce(h, group=self.group)
            return t.copy_(h)
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t):
        """Every rank's ``t`` concatenated along axis 0 in rank order, on
        ``t``'s device."""
        import torch
        import torch.distributed as dist

        src = (t.cpu() if self.host else t).contiguous()
        parts: List = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(t.device)

    def all_to_all(self, t, send_counts, recv_counts):
        """``t``'s rows (axis 0) sent in rank order, ``send_counts[r]`` to rank
        r; returns the rows every rank sent this one, in rank order
        (``recv_counts[r]`` from rank r), on ``t``'s device."""
        import torch
        import torch.distributed as dist

        src = (t.cpu() if self.host else t).contiguous()
        out = torch.empty((sum(recv_counts),) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.all_to_all_single(out, src, list(recv_counts), list(send_counts), group=self.group)
        return out.to(t.device)

    def exchange(self, shard, ex: Exchange):
        """This rank's frames in window order on ``shard``'s device, from the
        rank's ``shard`` of sharded resident frames (``mesh.Exchange``, one
        receiver and one holder a rank): one ``window_copy`` gathers the rows
        every rank takes from this one, one all-to-all moves them, and one
        more ``window_copy`` puts the rows received in window order."""
        from ..ops.shift_copy import window_copy

        mine = ex.send[self.rank]
        rows, order = upload_indices([np.concatenate(mine), ex.order[self.rank]], shard.device)
        sent = window_copy(shard, rows, 1)[:, 0]
        got = self.all_to_all(sent, ex.counts(self.rank), ex.received(self.rank))
        return window_copy(got, order, 1)[:, 0]

    def reducer(self) -> Reducer:
        """The BatchNorm sums of this process's one share summed over the ranks."""

        def total(parts):
            (own,) = parts
            return [self.all_reduce_(own.clone())]

        return Reducer(total, self.size)


def device_group(device) -> DeviceGroup:
    """The default group where it is NCCL and ``device`` a card, else its gloo
    twin (``host_group``) on host copies. Collective: every rank calls it."""
    import torch
    import torch.distributed as dist

    size, rank = process_count_index()
    if torch.device(device).type == "cuda" and "nccl" in str(dist.get_backend()):
        return DeviceGroup(None, size, rank, False)
    return DeviceGroup(host_group(), size, rank, True)
