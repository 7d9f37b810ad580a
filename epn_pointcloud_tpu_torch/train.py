"""Optimizer and learning-rate schedule (counterpart of
``epn_pointcloud_tpu/parallel/train.py``).

Adam with torch's defaults (betas 0.9, 0.999, eps 1e-8), as the JAX
package's ``optax.adam``; its learning rate is set before each step from a
staircase exponential decay ``init * rate^(step // decay_step)`` or a
constant.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def make_lr_schedule(init_lr: float, lr_type: str = 'exp_decay',
                     decay_rate: float = 0.5, decay_step: int = 10000,
                     **_unused) -> Callable[[int], float]:
    """step (the number of optimizer steps taken) -> learning rate."""
    if lr_type == 'constant':
        return lambda step: init_lr
    if lr_type == 'exp_decay':
        return lambda step: init_lr * decay_rate ** (step // decay_step)
    raise ValueError(f'unknown lr_type {lr_type}')


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   init_lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=init_lr, betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group['lr'] = lr
