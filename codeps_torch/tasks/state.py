"""Pretraining and online-adaptation state.

``TrainState`` is the counterpart of ``codeps_tpu/tasks/state.py:14``:
the modules, Adam over the live modules' parameters, the schedule, the
step count, the generator of the automask noise and the frozen modules.
Frozen modules take no gradient but, as in the JAX pretraining step, run
train-mode BatchNorm and update its running statistics.

``AdaptState`` is the counterpart of ``state.py:26-78``: the
student and its EMA teacher, the optimizer over the live modules, the
rolling ring of camera translation norms behind the non-moving-frame
skip (the reference's ``algos/depth.py:537-558``), the step count and
the generator of the step's random draws.

Per-module EMA alpha: ``ema_alpha`` for EMA-filtered modules, 0 (copy
the student) for the other live modules, 1 (keep) for frozen ones
(``adapt_codeps.py:294-299``). Frozen modules take no gradient and run
in eval mode; every BatchNorm of the student keeps its running
statistics (``models/resnet.py keep_running_stats``) and the teacher's
BatchNorm buffers are never blended.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Dict, Sequence

import torch

from codeps_torch.device import resolve_device
from codeps_torch.models.codeps_net import CodepsModules
from codeps_torch.models.resnet import keep_running_stats
from codeps_torch.tasks.optim import Schedule, build_optimizer

DIST_BUFFER_LEN = 300


@dataclasses.dataclass
class TrainState:
    modules: CodepsModules
    optimizer: torch.optim.Adam
    schedule: Schedule
    frozen_modules: tuple
    step: int
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.modules.parameters()).device

    def live_modules(self) -> list[str]:
        return [name for name in self.modules.module_names()
                if name not in self.frozen_modules]


def match_prefixes(names: Sequence[str], prefixes: Sequence[str]
                   ) -> tuple:
    """The names that start with one of ``prefixes`` (the reference
    freezes every parameter whose name starts with a given module
    string, ``train_utils.py:229-235``)."""
    return tuple(name for name in names
                 if any(name.startswith(p) for p in prefixes))


def make_train_state(modules: CodepsModules, schedule: Schedule | float,
                     frozen_modules: Sequence[str] = (), seed: int = 0,
                     device: str | torch.device | None = None
                     ) -> TrainState:
    """A fresh pretraining state on ``device`` (``cuda`` unless given)
    around ``modules``, which move there. ``schedule`` is the learning
    rate or a function of the step count giving it; ``frozen_modules``
    are module names; ``seed`` seeds the generator of the automask
    noise."""
    device = resolve_device(device)
    modules.to(device)
    frozen_modules, schedule, optimizer = _freeze(modules, frozen_modules,
                                                  schedule)
    return TrainState(
        modules=modules, optimizer=optimizer, schedule=schedule,
        frozen_modules=frozen_modules, step=0,
        generator=torch.Generator(device=device).manual_seed(seed))


@dataclasses.dataclass
class AdaptState:
    student: CodepsModules
    teacher: CodepsModules
    optimizer: torch.optim.Adam
    schedule: Schedule
    ema_modules: tuple
    frozen_modules: tuple
    ema_alpha: Dict[str, float]
    # Ring of camera translation norms on the device: values, valid
    # entries and write position.
    dist_buffer: torch.Tensor     # (300,) float32
    dist_count: torch.Tensor      # () int64
    dist_head: torch.Tensor       # () int64
    step: int
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.dist_buffer.device

    def live_modules(self) -> list[str]:
        return [name for name in self.student.module_names()
                if name not in self.frozen_modules]


def _constant(lr: float, count: int) -> float:
    return lr


def _freeze(modules: CodepsModules, frozen_modules: Sequence[str],
            schedule: Schedule | float):
    """(the frozen modules among ``modules``, which take no gradient; the
    schedule as a function of the step count; Adam over the other
    modules' parameters at the schedule's first rate)."""
    names = modules.module_names()
    frozen_modules = tuple(m for m in frozen_modules if m in names)
    for name in frozen_modules:
        getattr(modules, name).requires_grad_(False)
    if not callable(schedule):
        schedule = functools.partial(_constant, float(schedule))
    live = [p for name in names if name not in frozen_modules
            for p in getattr(modules, name).parameters()]
    return frozen_modules, schedule, build_optimizer(live, schedule(0))


def make_adapt_state(modules: CodepsModules, schedule: Schedule | float,
                     ema_modules: Sequence[str] = (),
                     frozen_modules: Sequence[str] = (),
                     ema_alpha: float = 0.99, seed: int = 0,
                     dist_buffer_len: int = DIST_BUFFER_LEN,
                     device: str | torch.device | None = None) -> AdaptState:
    """A fresh state on ``device`` (``cuda`` unless given) around
    ``modules``, which move there and become the student; the teacher is
    a copy of them.

    ``schedule`` is the learning rate, or a function of the step count
    giving it (``tasks/optim.py``). ``seed`` seeds the generator of the
    automask noise.
    """
    device = resolve_device(device)
    modules.to(device)
    names = modules.module_names()
    ema_modules = tuple(m for m in ema_modules if m in names)
    keep_running_stats(modules)
    frozen_modules, schedule, optimizer = _freeze(modules, frozen_modules,
                                                  schedule)
    teacher = copy.deepcopy(modules).eval().requires_grad_(False)
    alphas = {}
    for name in names:
        if name in ema_modules:
            alphas[name] = float(ema_alpha)
        elif name in frozen_modules:
            alphas[name] = 1.0
        else:
            alphas[name] = 0.0
    return AdaptState(
        student=modules, teacher=teacher,
        optimizer=optimizer, schedule=schedule,
        ema_modules=ema_modules, frozen_modules=frozen_modules,
        ema_alpha=alphas,
        dist_buffer=torch.zeros(dist_buffer_len, device=device),
        dist_count=torch.zeros((), dtype=torch.int64, device=device),
        dist_head=torch.zeros((), dtype=torch.int64, device=device),
        step=0,
        generator=torch.Generator(device=device).manual_seed(seed))
