"""Semantic segmentation metrics: confusion matrix and mIoU.

Counterpart of ``codeps_tpu/evaluation/semantic_metrics.py`` (the
reference's SemanticEvaluator). The confusion matrix is one bincount
over ``gt * C + pred``, the form the reference itself uses; the JAX
package's one-hot matmul is a TPU rewrite of the same count.
"""

from __future__ import annotations

from typing import Sequence

import torch


def compute_confusion_matrix(semantic_pred: torch.Tensor,
                             semantic_gt: torch.Tensor, num_classes: int,
                             ignore_classes: Sequence[int] = (),
                             ignore_index: int = 255) -> torch.Tensor:
    """(num_classes, num_classes) int32 confusion matrix, rows = GT, of
    the global batch inside a process group.
    Pixels whose GT is ``ignore_index`` or in ``ignore_classes`` are
    dropped; predictions are clamped into [0, C)."""
    pred = semantic_pred.reshape(-1).long().clamp(0, num_classes - 1)
    target = semantic_gt.reshape(-1).long()
    valid = (target != ignore_index) & (target >= 0) \
        & (target < num_classes)
    for cls in ignore_classes:
        valid &= target != cls
    key = torch.where(valid, target * num_classes + pred,
                      num_classes * num_classes)
    counts = torch.bincount(key, minlength=num_classes * num_classes + 1)
    counts = counts[:-1]
    return counts.reshape(num_classes, num_classes).to(torch.int32)
