"""Instance-head losses (Panoptic-DeepLab style).

Counterpart of ``codeps_tpu/losses/instance.py`` (the reference's
CenterLoss, OffsetLoss, BinaryMaskLoss and the EMA consistency terms).
Prediction and target come in the same layout; the reductions are plain
means over every element, as in the reference. The center, offset and
EMA terms take NHWC maps, the thing mask NCHW.
"""

from __future__ import annotations

import torch

from benchmark.reference.codeps_ref.losses.semantic import cross_entropy_per_pixel


def center_loss(prediction: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """MSE over the center heatmap."""
    diff = prediction - target
    return (diff * diff).mean()


def offset_loss(prediction: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """L1 over the (dy, dx) offset maps."""
    return torch.abs(prediction - target).mean()


def binary_mask_loss(prediction: torch.Tensor, target: torch.Tensor,
                     ignore_index: int = 255) -> torch.Tensor:
    """CE over the (B, 2, H, W) thing-mask probabilities; ignored pixels
    count 0 and still count in the mean, as torch's ``reduction='none'``
    followed by ``.mean()`` does."""
    return cross_entropy_per_pixel(prediction, target,
                                   ignore_index=ignore_index).mean()


def ema_consistency_loss(prediction: torch.Tensor,
                         ema_prediction: torch.Tensor) -> torch.Tensor:
    """``mean(-sigmoid(pred) * log(sigmoid(ema) + 1e-10))``."""
    return (-torch.sigmoid(prediction)
            * torch.log(torch.sigmoid(ema_prediction) + 1e-10)).mean()
