"""Optimizers and the learning-rate schedule of the reference surface.

Adam (b1 0.9, b2 0.999, eps 1e-8), SGD with momentum 0.9, or Adadelta
(rho 0.9, eps 1e-6), as ``torch.optim`` optimizers; these follow the same
update rules as the JAX package's optax choices (``training/optim.py``).

The ``StepLR`` schedule is *step-based*, as in the JAX package: the rate
is multiplied by 0.1 at every ``max(epochs // 3, 1) * steps_per_epoch``
optimizer steps. It is not torch's per-epoch ``StepLR``: ``schedule(step)``
gives the rate of optimizer step ``step`` (counted from 0), and the train
step sets it on the optimizer before each update.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch


def build_schedule(
    learning_rate: float, lr_scheduler: str, epochs: int, steps_per_epoch: int
) -> Callable[[int], float]:
    if lr_scheduler == "":
        return lambda step: learning_rate
    if lr_scheduler != "StepLR":
        raise ValueError(f"Invalid lr_scheduler: {lr_scheduler!r}")
    every = max(int(epochs / 3), 1)
    boundaries = [every * steps_per_epoch * k for k in range(1, epochs // every + 1)]

    def schedule(step: int) -> float:
        lr = learning_rate
        for b in boundaries:
            if step >= b:
                lr *= 0.1
        return lr

    return schedule


def build_optimizer(
    optim_name: str,
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    lr_scheduler: str = "",
    epochs: int = 1,
    steps_per_epoch: int = 1,
) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """Returns ``(optimizer, schedule)``."""
    schedule = build_schedule(learning_rate, lr_scheduler, epochs, steps_per_epoch)
    if optim_name == "Adam":
        opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    elif optim_name == "SGD":
        opt = torch.optim.SGD(params, lr=learning_rate, momentum=0.9)
    elif optim_name == "Adadelta":
        opt = torch.optim.Adadelta(params, lr=learning_rate, rho=0.9, eps=1e-6)
    else:
        raise ValueError(f"Invalid optimizer: {optim_name!r}")
    return opt, schedule
