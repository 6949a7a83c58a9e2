"""Semantic segmentation metrics: confusion matrix and mIoU.

Counterpart of ``codeps_tpu/evaluation/semantic_metrics.py`` (the
reference's SemanticEvaluator). The confusion matrix is one bincount
over ``gt * C + pred``, the form the reference itself uses; the JAX
package's one-hot matmul is a TPU rewrite of the same count. Inside a
process group (``parallel/dist.py``) the matrix counts every rank's
pixels.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from codeps_torch import parallel


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
    counts = parallel.all_reduce(counts[:-1])
    return counts.reshape(num_classes, num_classes).to(torch.int32)


def compute_sem_miou(conf_mat, num_classes: int,
                     ignore_classes: Sequence[int] = (),
                     sum_pixels: bool = False):
    """Per-class IoU from a confusion matrix, or with ``sum_pixels`` the
    pixel-weighted IoU over all classes (float64 numpy)."""
    if isinstance(conf_mat, torch.Tensor):
        conf_mat = conf_mat.cpu().numpy()
    conf_mat = np.asarray(conf_mat, dtype=np.float64)
    keep = np.array([i for i in range(num_classes)
                     if i not in set(ignore_classes)])
    filtered = conf_mat[keep][:, keep]
    intersection = np.diag(filtered)
    union = filtered.sum(axis=1) + filtered.sum(axis=0) - intersection + 1e-8
    if sum_pixels:
        return intersection.sum() / union.sum()
    return intersection / union
