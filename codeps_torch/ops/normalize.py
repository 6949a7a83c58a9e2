"""On-device image normalization for raw uint8 frames.

Counterpart of ``codeps_tpu/ops/normalize.py``: uint8 frames are
normalized with the same constants and the same order of operations;
float inputs are taken as already normalized and pass through.
"""

from __future__ import annotations

import torch

from codeps_torch.device import constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def maybe_normalize(images: torch.Tensor, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD) -> torch.Tensor:
    """Normalize channel-last uint8 images; pass floats through untouched.

    Args:
      images: (..., 3) uint8 raw frames or float32 already-normalized.
    """
    if images.dtype != torch.uint8:
        return images
    mean_t = constant(mean, torch.float32, images.device)
    std_t = constant(std, torch.float32, images.device)
    return (images.to(torch.float32) / 255.0 - mean_t) / std_t
