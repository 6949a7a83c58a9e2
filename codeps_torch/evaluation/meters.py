"""Stateful metric meters on the host (numpy).

Counterpart of ``codeps_tpu/evaluation/meters.py``: ConstantMeter keeps
the last value, AverageMeter is a momentum-weighted running mean,
PanopticMeter and ConfusionMatrixMeter accumulate matrices and derive
PQ and IoU/precision/recall from them.
"""

from __future__ import annotations

import numpy as np


class Meter:
    def state_dict(self) -> dict:
        return {key: getattr(self, key) for key in self._STATE}

    def load_state_dict(self, state: dict) -> None:
        # an unexpected key fails the load instead of resuming with
        # zeroed state
        for key in state:
            if key not in self._STATE:
                raise KeyError(
                    f"Unexpected key {key!r} in state dict when loading "
                    f"{type(self).__name__}")
        for key in self._STATE:
            if key in state:
                setattr(self, key, state[key])

    _STATE: tuple = ()


class ConstantMeter(Meter):
    _STATE = ("last",)

    def __init__(self, shape=()):
        self.last = np.zeros(shape, np.float32)

    def update(self, value) -> None:
        self.last = np.asarray(value, np.float32)

    @property
    def value(self):
        return self.last


class AverageMeter(ConstantMeter):
    _STATE = ("last", "sum", "count")

    def __init__(self, shape=(), momentum: float = 1.0):
        super().__init__(shape)
        self.sum = np.zeros(shape, np.float64)
        self.count = 0.0
        self.momentum = momentum

    def update(self, value) -> None:
        super().update(value)
        self.sum = self.sum * self.momentum + np.asarray(value, np.float64)
        self.count = self.count * self.momentum + 1.0

    @property
    def mean(self):
        if self.count == 0:
            return np.zeros_like(self.sum)
        return self.sum / self.count

    @property
    def value(self):
        return self.mean


class PanopticMeter(AverageMeter):
    """Accumulates (iou_sum, tp, fn, fp) rows and derives per-class PQ.

    PQ = iou / (tp + 0.5 fn + 0.5 fp), averaged over classes for the
    scalar value.
    """

    def __init__(self, num_classes: int, momentum: float = 1.0):
        super().__init__((4, num_classes), momentum)

    def panoptic(self):
        # no clamp of the denominator: a class never seen is 0/0 = NaN,
        # which shows in the mean instead of a made-up PQ of 0
        denom = self.sum[1] + 0.5 * self.sum[2] + 0.5 * self.sum[3]
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.sum[0] / denom

    @property
    def value(self):
        if self.count == 0:
            return np.float32(0.0)
        return self.panoptic().mean()


class ConfusionMatrixMeter(AverageMeter):
    def __init__(self, num_classes: int, momentum: float = 1.0):
        super().__init__((num_classes, num_classes), momentum)

    @property
    def iou(self):
        mat = self.sum
        intersection = np.diag(mat)
        union = mat.sum(axis=1) + mat.sum(axis=0) - intersection + 1e-8
        return intersection / union

    @property
    def precision(self):
        mat = self.sum
        return np.diag(mat) / (mat.sum(axis=0) + 1e-8)

    @property
    def recall(self):
        mat = self.sum
        return np.diag(mat) / (mat.sum(axis=1) + 1e-8)
