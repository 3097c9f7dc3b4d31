"""The caller's ``torch.distributed`` process group, as the multi-process
paths of the port read it: rally evaluation (``RallyTestEngine.test``) and
the validation loops (``evaluation/loops.py``) merge their results on the
host over ``host_group()``, and the train loop refuses a group of more than
one process (``process_count_index``)."""

from __future__ import annotations

from typing import Tuple

_GLOO = None  # (default process group, its gloo twin): host_group


def process_count_index() -> Tuple[int, int]:
    """(world size, rank) of the initialised default process group, else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


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
