"""Host spans and counters of the adaptation stream, on the profiler's
clock.

``frame(index, phases, counters)`` opens one streamed frame on the
calling thread. While it is open:

- ``span(name)`` adds the host seconds of its block to the frame's entry
  under ``name`` (steps after the first of a frame add to the same
  entry);
- ``clock(start)`` makes contiguous phases: each ``with phase(name):``
  lasts from the end of the phase before it (or ``start``) to the end of
  its block, so the phases sum to the time since ``start``;
- ``upload`` counts each copy of host memory to another device in the
  frame's ``h2d_bytes``, ``h2d_pageable_bytes`` (the source not pinned)
  and ``h2d_copies``.
- ``count(name, value)`` adds to the frame's counter ``name`` (the
  adaptation step's ``step.eager_steps``, ``step.graph_captures`` and
  ``step.graph_replays``, ``tasks/step_graph.py``).

On a normal exit the frame appends one entry to the lists of
``phases`` and ``counters`` under each name it saw. A span or upload
with no frame open on its thread records nothing: a step called outside
the runner, or on a rank that follows a row split.

While ``torch.profiler`` records, every span, phase and frame is also a
``codeps.<name>`` range on the profiler's host timeline, which Kineto
aligns with the card's events, with the frame index as its argument
(shown with ``record_shapes=True``). The profiler records the ranges of
the thread that started it only. With no profiler recording no range
is opened: a span checks ``torch.autograd._profiler_enabled`` once.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

PREFIX = "codeps."

_local = threading.local()


class Frame:
    """One frame's host seconds and counts, by name."""

    __slots__ = ("index", "phases", "counters")

    def __init__(self, index: int):
        self.index = index
        self.phases: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}


def _open() -> Optional[Frame]:
    return getattr(_local, "frame", None)


def _add(values: dict, name: str, value) -> None:
    values[name] = values.get(name, 0) + value


def _enter(name: str, opened: Optional[Frame]):
    """The profiler's range ``codeps.<name>``, opened only while it
    records (None otherwise)."""
    if not torch.autograd._profiler_enabled():
        return None
    args = () if opened is None else (opened.index,)
    return torch.autograd._record_function_with_args_enter(PREFIX + name,
                                                           *args)


def _exit(record) -> None:
    if record is not None:
        torch.autograd._record_function_with_args_exit(record)


class span:
    """A block of host work named ``name``: its seconds into the open
    frame, and a range on the profiler's timeline while it records."""

    __slots__ = ("name", "_frame", "_start", "_record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._frame = _open()
        self._record = _enter(self.name, self._frame)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._end(time.perf_counter())
        _exit(self._record)
        return False

    def _end(self, now: float) -> None:
        if self._frame is not None:
            _add(self._frame.phases, self.name, now - self._start)


class clock:
    """Contiguous phases from ``start`` (a ``time.perf_counter`` reading):
    ``with phase(name):`` for ``phase = clock(start)``."""

    def __init__(self, start: float):
        self.last = start

    def __call__(self, name: str) -> "_Phase":
        return _Phase(name, self)


class _Phase(span):
    """A span that starts where its clock's last phase ended."""

    __slots__ = ("_clock",)

    def __init__(self, name: str, owner: clock):
        super().__init__(name)
        self._clock = owner

    def __enter__(self):
        super().__enter__()
        self._start = self._clock.last
        return self

    def _end(self, now: float) -> None:
        super()._end(now)
        self._clock.last = now


@contextlib.contextmanager
def frame(index: int, phases: Dict[str, List[float]],
          counters: Dict[str, List[int]]):
    """Frame ``index`` open on this thread (the ``codeps.frame`` range);
    on a normal exit its seconds join ``phases`` and its counts
    ``counters``, one entry a frame."""
    opened = Frame(index)
    outer = _open()
    _local.frame = opened
    record = _enter("frame", opened)
    try:
        yield opened
    finally:
        _exit(record)
        _local.frame = outer
    for lists, values in ((phases, opened.phases),
                          (counters, opened.counters)):
        for name, value in values.items():
            lists.setdefault(name, []).append(value)


def count(name: str, value: int = 1) -> None:
    """Adds ``value`` to the open frame's counter ``name``; nothing with
    no frame open on this thread."""
    opened = _open()
    if opened is not None:
        _add(opened.counters, name, value)


def upload(tensor: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """``tensor`` on ``device`` (in ``dtype`` where given); a copy from
    host memory to another device adds to the open frame's counters. A
    copy that also converts stages through pageable memory."""
    opened = _open()
    if opened is not None and tensor.device.type == "cpu" \
            and torch.device(device).type != "cpu":
        out_dtype = dtype or tensor.dtype
        nbytes = tensor.numel() * out_dtype.itemsize
        pinned = out_dtype == tensor.dtype and tensor.is_pinned()
        _add(opened.counters, "h2d_bytes", nbytes)
        _add(opened.counters, "h2d_pageable_bytes", 0 if pinned else nbytes)
        _add(opened.counters, "h2d_copies", 1)
    return tensor.to(device, dtype)
