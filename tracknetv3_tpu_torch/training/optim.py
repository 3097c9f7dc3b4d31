"""Optimizers and the learning-rate schedule of the reference surface.

Adam (b1 0.9, b2 0.999, eps 1e-8), SGD with momentum 0.9, or Adadelta
(rho 0.9, eps 1e-6), as ``torch.optim`` optimizers; these follow the same
update rules as the JAX package's optax choices (``training/optim.py``).

With ``clip_norm`` (InpaintNet: 1.0) every ``optimizer.step()`` first
clips the gradients by their global norm as ``optax.clip_by_global_norm``
does: left alone when the norm is under ``clip_norm``, else ``g / norm *
clip_norm``. ``torch.nn.utils.clip_grad_norm_`` scales by ``clip_norm /
(norm + 1e-6)`` at every norm, another function, so the clip is written out
(``clip_by_global_norm_``) and runs as the optimizer's step pre-hook, where
optax chains it before the update.

The ``StepLR`` schedule is *step-based*, as in the JAX package: the rate
is multiplied by 0.1 at every ``max(epochs // 3, 1) * steps_per_epoch``
optimizer steps. It is not torch's per-epoch ``StepLR``: ``schedule(step)``
gives the rate of optimizer step ``step`` (counted from 0), and the train
step sets it on the optimizer before each update.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

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


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm(max_norm)`` in place: every gradient is
    left alone when the global norm ``sqrt(sum(g^2))`` is under
    ``max_norm``, else replaced by ``g / norm * max_norm``. Returns the norm
    (a device scalar: no host sync)."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def build_optimizer(
    optim_name: str,
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    lr_scheduler: str = "",
    epochs: int = 1,
    steps_per_epoch: int = 1,
    clip_norm: Optional[float] = None,
) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """Returns ``(optimizer, schedule)``; with ``clip_norm`` the optimizer
    clips its gradients by their global norm before each step."""
    schedule = build_schedule(learning_rate, lr_scheduler, epochs, steps_per_epoch)
    if optim_name == "Adam":
        opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    elif optim_name == "SGD":
        opt = torch.optim.SGD(params, lr=learning_rate, momentum=0.9)
    elif optim_name == "Adadelta":
        opt = torch.optim.Adadelta(params, lr=learning_rate, rho=0.9, eps=1e-6)
    else:
        raise ValueError(f"Invalid optimizer: {optim_name!r}")
    if clip_norm is not None:
        def clip(optimizer, args, kwargs):
            grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                     if p.grad is not None]
            if grads:
                clip_by_global_norm_(grads, clip_norm)

        opt.register_step_pre_hook(clip)
    return opt, schedule
