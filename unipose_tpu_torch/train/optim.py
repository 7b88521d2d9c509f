"""Optimizer and LR schedule.

Counterpart of ``unipose_tpu/train/optim.py``.  Reference recipe: Adam at
1e-4 (unipose.py:70-72) with a step-decay schedule ``lr = base *
gamma^(iters // step_size)``, gamma 0.333 and step_size 13275, applied at
every update (utils/utils.py:42-51, unipose.py:51-52,107).  The schedule is
a function of the update count, wired through ``LambdaLR``; the scheduler
steps once after each ``optimizer.step()``, so update n runs at
``schedule(n)``, as optax's count-based schedules do.  ``torch.optim.Adam``
with betas (0.9, 0.999) and eps 1e-8 (added after the square root) is
optax.adam's update.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch
import torch.nn as nn
from torch.optim.lr_scheduler import LambdaLR

from unipose_tpu_torch.core.config import TrainConfig


def step_decay_schedule(
    base_lr: float, gamma: float, step_size: int, warmup_steps: int = 0
) -> Callable[[int], float]:
    """The learning rate of update ``count``: the staircase ``base *
    gamma^(count // step_size)``; with a warmup, a linear ramp from 0 to
    ``base`` over ``warmup_steps`` updates, then the staircase counted from
    the ramp's end (optax.join_schedules)."""

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return base_lr * count / warmup_steps
        return base_lr * gamma ** ((count - warmup_steps) // step_size)

    return schedule


def _adam(groups: Iterable, config: TrainConfig, warmup_steps: int) -> Tuple[torch.optim.Adam, LambdaLR]:
    optimizer = torch.optim.Adam(groups, lr=config.lr, betas=(0.9, 0.999), eps=1e-8)
    # each group's rate is its base rate times the schedule at base rate 1
    factor = step_decay_schedule(1.0, config.gamma, config.step_size, warmup_steps)
    return optimizer, LambdaLR(optimizer, factor)


def make_optimizer(params: Iterable[nn.Parameter], config: TrainConfig):
    """Adam over ``params`` and its step-decay scheduler (with
    ``config.warmup_steps``).  Returns (optimizer, scheduler)."""
    return _adam(params, config, config.warmup_steps)


def make_optimizer_with_lr_groups(model: nn.Module, config: TrainConfig):
    """Differential LR: the parameters under ``backbone`` at 1x, everything
    else at 10x, both on the staircase without warmup (the intended
    ``get_1x_lr_params``/``get_10x_lr_params`` of model/unipose.py:47-65).
    Returns (optimizer, scheduler)."""
    backbone, head = [], []
    for name, p in model.named_parameters():
        (backbone if name.split(".")[0] == "backbone" else head).append(p)
    groups = [
        {"params": backbone, "lr": config.lr},
        {"params": head, "lr": config.lr * 10.0},
    ]
    return _adam(groups, config, 0)
