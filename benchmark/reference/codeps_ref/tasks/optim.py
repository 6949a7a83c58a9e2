"""Optimizer and learning-rate schedules.

Counterpart of ``codeps_tpu/tasks/optim.py``: Adam with torch's defaults
(b1 0.9, b2 0.999, eps 1e-8) over the live modules' parameters only, and
the reference's StepLR and WarmupPolyLR (``misc/solver.py:9-70``) as
functions of the step count. The JAX package masks frozen modules out of
its optax transform; here they have no parameter in the optimizer at all.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def warmup_poly_schedule(base_lr: float, max_iters: int,
                         warmup_factor: float = 0.001,
                         warmup_iters: int = 1000,
                         warmup_method: str = "linear",
                         power: float = 0.9,
                         constant_ending: float = 0.0) -> Schedule:
    """Panoptic-DeepLab's poly schedule with warm-up."""
    if warmup_method not in ("constant", "linear"):
        raise ValueError(f"Unknown warmup method: {warmup_method}")

    def schedule(count: int) -> float:
        if count >= warmup_iters:
            factor = 1.0
        elif warmup_method == "constant":
            factor = warmup_factor
        else:
            alpha = count / warmup_iters
            factor = warmup_factor * (1.0 - alpha) + alpha
        poly = max(1.0 - count / max_iters, 0.0) ** power
        if constant_ending > 0 and factor == 1.0 and poly < constant_ending:
            return base_lr * constant_ending
        return base_lr * factor * poly

    return schedule


def step_lr_schedule(base_lr: float, step_size_epochs: int, gamma: float,
                     steps_per_epoch: int) -> Schedule:
    """torch StepLR with per-epoch decay boundaries."""

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // step_size_epochs)

    return schedule


def build_schedule(cfg, steps_per_epoch: int) -> Schedule:
    """The schedule that ``cfg.train.scheduler`` names."""
    sched_type = cfg.train.scheduler.type
    base_lr = cfg.train.optimizer.learning_rate
    if sched_type == "StepLR":
        return step_lr_schedule(base_lr, cfg.train.scheduler.step_lr.step_size,
                                cfg.train.scheduler.step_lr.gamma,
                                steps_per_epoch)
    if sched_type == "WarmupPolyLR":
        warm = cfg.train.scheduler.warmup
        return warmup_poly_schedule(base_lr, warm.max_iters, warm.factor,
                                    warm.iters, warm.method, warm.power,
                                    warm.constant_ending)
    if sched_type == "None":
        return lambda count: base_lr
    raise NotImplementedError(f"Scheduler {sched_type} not implemented")


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    lr: float) -> torch.optim.Adam:
    """Adam with torch's defaults over ``params`` (the live modules'
    parameters); a schedule sets ``lr`` of its param groups per step."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
